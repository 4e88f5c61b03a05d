"""Deterministic, seedable fault injection for the serving control plane.

The port of :mod:`repro.ft.injection`: the same plans (``FaultPlan.sample``
draws the same numpy streams, so a seed gives the reference's plan). The
recovery story (:class:`~repro_torch.ft.manager.ServeSupervisor`,
``tests/test_torch_serve_ft.py``) is only testable if faults are
reproducible. This module injects three fault classes:

* **step-fn crashes** — :class:`~repro_torch.ft.faults.StepCrash` raised before
  the chosen engine step runs (the kill-the-process stand-in; the engine
  state at the crash point is whatever the last completed step left);
* **allocator exhaustion** — admission sees zero free pages for a window
  of steps (:attr:`FaultPlan.exhaust_steps` gates
  ``Batcher.admission_gate``), driving the page-pressure paths: stalled
  admission, preemption, and — when nothing at all is in flight — the
  engine's recoverable :class:`~repro_torch.ft.faults.ResourceExhausted`;
* **straggler steps** — an injected sleep before the step, flagged by the
  supervisor's :class:`~repro_torch.ft.manager.StragglerWatchdog`.

Faults are keyed by the injector's **attempt counter**, which increments on
every ``before_step`` call and NEVER rewinds on restore — so each planned
crash fires exactly once and every exhaustion window eventually passes,
regardless of how far a restart rewinds the engine's own step counter.
"""
from __future__ import annotations

import dataclasses
import time
from typing import FrozenSet

import numpy as np

from repro_torch.ft.faults import StepCrash


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Which attempt indices fault, and how. Build explicitly for targeted
    tests or via :meth:`sample` for seeded random soak runs."""
    crash_steps: FrozenSet[int] = frozenset()
    exhaust_steps: FrozenSet[int] = frozenset()
    straggle_steps: FrozenSet[int] = frozenset()
    straggle_s: float = 0.25

    @classmethod
    def sample(cls, seed: int, n_steps: int, *, crash_rate: float = 0.0,
               exhaust_rate: float = 0.0, straggle_rate: float = 0.0,
               straggle_s: float = 0.25) -> "FaultPlan":
        """Deterministic plan: each attempt in ``[0, n_steps)`` faults
        independently at the given rates (one seeded stream per class)."""
        rng = np.random.default_rng(seed)

        def pick(rate):
            return frozenset(
                int(i) for i in np.nonzero(rng.random(n_steps) < rate)[0])

        return cls(crash_steps=pick(crash_rate),
                   exhaust_steps=pick(exhaust_rate),
                   straggle_steps=pick(straggle_rate),
                   straggle_s=straggle_s)


class FaultInjector:
    """Executes a :class:`FaultPlan` against a supervised serving run.

    The supervisor calls :meth:`before_step` ahead of every engine step and
    :meth:`attach` after every engine (re)build; ``injected`` counts what
    actually fired (tests assert against it)."""

    def __init__(self, plan: FaultPlan, sleep=time.sleep):
        self.plan = plan
        self._sleep = sleep
        self.attempts = 0
        self._current = -1
        self.injected = {"crashes": 0, "exhaustions": 0, "stragglers": 0}

    def attach(self, engine) -> None:
        """Wire the exhaustion gate into the engine's admission path."""
        engine.batcher.admission_gate = self.admission_open

    def admission_open(self) -> bool:
        """False while the current attempt sits in an exhaustion window —
        admission then behaves exactly as if the page pool were empty."""
        if self._current in self.plan.exhaust_steps:
            self.injected["exhaustions"] += 1
            return False
        return True

    def before_step(self, engine_step: int) -> None:
        """Fire this attempt's faults. Raises
        :class:`~repro_torch.ft.faults.StepCrash` for crash attempts; sleeps for
        straggler attempts; exhaustion is consulted lazily via the gate."""
        a = self.attempts
        self.attempts += 1
        self._current = a
        if a in self.plan.straggle_steps:
            self.injected["stragglers"] += 1
            self._sleep(self.plan.straggle_s)
        if a in self.plan.crash_steps:
            self.injected["crashes"] += 1
            raise StepCrash(f"injected crash at attempt {a} "
                            f"(engine step {engine_step})")
