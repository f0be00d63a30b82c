"""Learning-rate schedules (cosine with linear warmup, per the paper).

Mirror of ``repro.core.schedule``: the schedule is evaluated in fp32 from the
integer step and returns a 0-d fp32 tensor on the CPU. Optimizers move the
scalars they derive from it to the device once per step, so reading the
learning rate never waits for the device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.types import Schedule


def cosine_with_warmup(peak_lr: float, total_steps: int,
                       warmup_frac: float = 0.1,
                       min_ratio: float = 0.0) -> Schedule:
    warmup_steps = max(1, int(total_steps * warmup_frac))

    def schedule(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * step / warmup_steps
        progress = torch.clamp(
            (step - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                         * (1 + torch.cos(math.pi * progress)))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule


def constant(lr: float) -> Schedule:
    def schedule(step):
        del step
        return torch.tensor(lr, dtype=torch.float32)
    return schedule
