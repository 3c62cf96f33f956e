"""Learning-rate schedules: pure functions of the step, the counterparts
of ``repro.optim.schedules``.  The step is an int32 tensor (the optimizer
state's, on its device) and the rate a float32 tensor on the same device:
nothing is read back to the host per step."""
from __future__ import annotations

import math

import torch


def constant_lr(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def linear_warmup_cosine(peak_lr: float, warmup_steps: int,
                         total_steps: int, floor: float = 0.1):
    def f(step):
        step = step.to(torch.float32)
        warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return f
