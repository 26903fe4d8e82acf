"""Learning-rate schedules (the port of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def cosine_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    """Linear warm-up to ``peak_lr``, then a cosine decay to ``min_ratio``
    of it at ``total_steps``. The schedule takes the step count (an int or
    an integer tensor) and returns a float32 0-dim tensor, computed in
    float32 in the reference's order of operations."""
    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        progress = torch.clamp((step - warmup_steps)
                               / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                         * (1 + torch.cos(math.pi * progress)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule
