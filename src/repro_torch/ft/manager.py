"""Run manager, training part: the straggler watchdog.

The port of :class:`repro.ft.manager.StragglerWatchdog`: per-step
wall-time EWMA; a step exceeding ``threshold x`` the EWMA is flagged. The
restart loop, the serving supervisor and elastic rescale come with the
obs/ft slice (ROADMAP queue 1, 'obs/ft').
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class StragglerWatchdog:
    threshold: float = 3.0      # x EWMA counts as straggler
    alpha: float = 0.1          # EWMA smoothing
    warmup_steps: int = 3       # compile steps excluded
    _ewma: Optional[float] = None
    _seen: int = 0
    events: int = 0

    def observe(self, step_time: float) -> bool:
        """Record one step; True if flagged as straggler."""
        self._seen += 1
        if self._seen <= self.warmup_steps:
            return False
        if self._ewma is None:
            self._ewma = step_time
            return False
        flagged = step_time > self.threshold * self._ewma
        if flagged:
            self.events += 1
        else:  # stragglers don't poison the baseline
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * step_time
        return flagged
