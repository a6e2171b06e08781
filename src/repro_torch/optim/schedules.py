"""LR schedules as plain callables step -> scale (copy of
``src/repro/optim/schedules.py``; no framework)."""
from __future__ import annotations

import math


def constant():
    return lambda step: 1.0


def cosine(total_steps: int, warmup: int = 0, floor: float = 0.1):
    def f(step):
        if warmup and step < warmup:
            return step / max(warmup, 1)
        frac = min(1.0, (step - warmup) / max(total_steps - warmup, 1))
        return floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac))
    return f


def inverse_sqrt(warmup: int = 100):
    def f(step):
        return min(1.0, (step + 1) / warmup) / math.sqrt(
            max(step, warmup) / warmup)
    return f
