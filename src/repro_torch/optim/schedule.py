"""LR schedules: linear warmup + {cosine, rsqrt, constant} decay.

The port of :mod:`repro.optim.schedule`, on the host: the step is a Python
int and the scale a Python float (the reference computes it in f32 on the
device)."""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Schedule:
    warmup_steps: int = 100
    total_steps: int = 10000
    kind: str = "cosine"       # cosine | rsqrt | constant
    min_ratio: float = 0.1

    def __call__(self, step: int) -> float:
        s = float(step)
        warm = min(s / max(self.warmup_steps, 1), 1.0)
        if self.kind == "constant":
            decay = 1.0
        elif self.kind == "rsqrt":
            decay = math.sqrt(max(self.warmup_steps, 1)
                              / max(s, self.warmup_steps))
        else:  # cosine
            frac = min(max((s - self.warmup_steps)
                           / max(self.total_steps - self.warmup_steps, 1),
                           0.0), 1.0)
            decay = self.min_ratio + (1 - self.min_ratio) * 0.5 * (
                1 + math.cos(math.pi * frac))
        return warm * decay
