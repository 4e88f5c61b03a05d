"""Run manager: straggler watchdog, the restart loop, the serving
supervisor.

The port of :mod:`repro.ft.manager`:

* **StragglerWatchdog** — per-step wall-time EWMA; a step exceeding
  ``threshold x`` the EWMA is flagged. The train loop feeds it train
  steps, :class:`ServeSupervisor` serving-engine steps.
* **run_with_restarts** — the training supervisor loop: run the step fn,
  on a recoverable fault (:data:`repro_torch.ft.faults.RECOVERABLE`)
  restore the latest checkpoint and continue, under a bounded restart
  budget with exponential backoff, so a deterministically failing step
  raises :class:`~repro_torch.ft.faults.RestartsExhausted` instead of
  looping forever.
* **ServeSupervisor** — the serving twin: drives a
  :class:`~repro_torch.serve.engine.ContinuousEngine` step by step,
  snapshotting its full state (``ContinuousEngine.state_dict``) every
  ``checkpoint_every`` steps through the atomic keep-k writer, and on a
  fault rebuilds the engine and restores the latest snapshot. Greedy
  token output is exactly-once: a run killed at any step and resumed
  emits the tokens of an uninterrupted run
  (``tests/test_torch_serve_ft.py``). Work lost per restart is bounded by
  the checkpoint interval. A sequence-parallel engine runs one supervisor
  per rank (``group=``): each rank snapshots its own slabs to
  ``ckpt_dir/rank{r}`` at the same step boundaries, and an injected fault
  (a seeded :class:`~repro_torch.ft.injection.FaultPlan`, the same on
  every rank) restarts every rank from the same snapshot step.

* **reshard** — elastic rescale: a live tree re-placed onto other devices
  (a data-parallel state is replicated, so a placement is a device) or
  between split layouts (``(data, model)`` placements of ``Shard`` /
  ``Replicate`` over the axes of the mesh: tensor parallelism's model
  splits, the FSDP fallback's data splits; 1 -> n, n -> m, n -> 1).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.ft.checkpoint import (CheckpointManager, _slice,
                                      gather_tree, placements)
from repro_torch.ft.faults import RECOVERABLE, RestartsExhausted, StepCrash
from repro_torch.obs import Observability
from repro_torch.tree import tree_flatten_with_path, tree_unflatten

_BACKOFF_CAP_S = 30.0


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


def reshard(tree: Any, shardings: Any, model_group=None, *,
            current: Any = None, current_group=None, data_group=None,
            current_data_group=None) -> Any:
    """Re-place a live tree onto new placements (elastic rescale).
    ``shardings`` is one placement for every leaf or a tree of them
    matched by path (:func:`repro_torch.ft.checkpoint.placements`): a
    device, where the tensor leaf moves (a data-parallel state is
    replicated), or a ``(data, model)`` tuple of ``Shard`` /
    ``Replicate``, this rank's slice on each split axis (``data_group``,
    ``model_group``). ``current``/
    ``current_group``/``current_data_group``: the layout the tree is in
    now, if it holds slices: they are gathered over those groups first.
    So 1 -> n is ``shardings`` alone, n -> 1 is ``current`` with a device
    (or None) as ``shardings``, n -> m both, ``m`` dividing the leaves as
    ``n`` does (FSDP D -> D', FSDP <-> plain ``--data``). Other leaves
    (the optimizer's ``int`` step) stay as they are. Every rank of a
    group that gathers calls it."""
    if current is not None:
        tree = gather_tree(tree, current, current_group, current_data_group)
    flat, treedef = tree_flatten_with_path(tree)
    where = placements(shardings, [p for p, _ in flat])

    def place(x, w):
        if not isinstance(x, torch.Tensor) or w is None:
            return x
        if isinstance(w, torch.device):
            return x.to(w)
        return _slice(x, w, model_group, data_group)
    return tree_unflatten(treedef, [place(x, w)
                                    for (_, x), w in zip(flat, where)])


def _backoff_sleep(backoff: float, n_restarts: int, sleep=time.sleep):
    if backoff > 0.0:
        sleep(min(backoff * (2 ** max(n_restarts - 1, 0)), _BACKOFF_CAP_S))


def run_with_restarts(step_fn: Callable, state: Any, n_steps: int,
                      manager, *, checkpoint_every: int = 50,
                      fail_at: Optional[set] = None,
                      watchdog: Optional[StragglerWatchdog] = None,
                      start_step: int = 0, max_restarts: int = 16,
                      backoff: float = 0.0, recoverable=RECOVERABLE,
                      obs: Optional[Observability] = None):
    """Supervisor loop with checkpoint/restart semantics.

    ``step_fn(state, step) -> state``; ``fail_at``: steps at which to inject
    a :class:`~repro_torch.ft.faults.StepCrash` (tests). Only ``recoverable``
    exceptions (default: the :mod:`repro_torch.ft.faults` taxonomy — NOT bare
    ``RuntimeError``) trigger a restore; each restart sleeps
    ``backoff * 2**k`` (capped) and after ``max_restarts`` restarts the
    loop raises :class:`~repro_torch.ft.faults.RestartsExhausted` chaining the
    last fault — a deterministically failing step can no longer spin
    forever. ``obs``: checkpoint saves, faults, restores, and straggler
    flags land on the tracer's ``ft`` track + the registry (the same event
    vocabulary :class:`ServeSupervisor` emits). Returns (state, history
    dict).
    """
    fail_at = set(fail_at or ())
    obs = obs if obs is not None else Observability()
    history = {"restarts": 0, "straggler_events": 0, "steps_run": 0}
    step, state0 = start_step, state
    while step < n_steps:
        try:
            t0 = time.perf_counter()
            if step in fail_at:
                fail_at.discard(step)
                raise StepCrash(f"injected failure at step {step}")
            with obs.tracer.span("train.step", track="ft", step=step):
                state = step_fn(state, step)
            dt = time.perf_counter() - t0
            if watchdog is not None and watchdog.observe(dt):
                history["straggler_events"] += 1
                obs.registry.inc("ft_straggler_events")
                obs.tracer.instant("ft.straggler", track="ft", step=step,
                                   step_time_s=round(dt, 6))
            history["steps_run"] += 1
            if checkpoint_every and (step + 1) % checkpoint_every == 0:
                manager.save(state, step + 1)
                obs.tracer.instant("ft.snapshot", track="ft", step=step + 1)
        except recoverable as e:
            history["restarts"] += 1
            obs.registry.inc("ft_faults", kind=type(e).__name__)
            obs.tracer.instant("ft.fault", track="ft", step=step,
                               kind=type(e).__name__, message=str(e))
            if history["restarts"] > max_restarts:
                raise RestartsExhausted(
                    f"step fn still failing after {max_restarts} restarts "
                    f"(last fault: {e})") from e
            _backoff_sleep(backoff, history["restarts"])
            restored, ck_step = manager.restore_latest(state)
            if restored is None:   # no checkpoint yet: from scratch, with
                state, step = state0, start_step   # the state it began with
            else:
                state, step = restored, ck_step
            obs.registry.inc("ft_restarts")
            obs.tracer.instant("ft.restore", track="ft", step=step,
                               restarts=history["restarts"])
            continue
        step += 1
    manager.wait()
    return state, history


class ServeSupervisor:
    """Fault-tolerant runner of the continuous serving engine.

    ``make_engine()`` must return a fully-loaded engine — constructed AND
    with its requests submitted; the supervisor then overwrites the
    engine's state wholesale from the latest snapshot (if any), so the
    factory is also the "restart from scratch" path when no checkpoint
    exists yet. It may return a fresh engine each call (the true
    killed-process semantics) or the same engine object (in-process
    recovery; ``load_state`` is a wholesale replacement, so a
    boundary-consistent engine is restored correctly either way).

    Per step: run injected faults (``injector.before_step``), one
    ``engine.step``, feed the watchdog, snapshot every
    ``checkpoint_every`` engine steps. On a recoverable fault
    (:data:`repro_torch.ft.faults.RECOVERABLE`): bounded restarts with
    exponential backoff, engine rebuilt + restored from the latest
    snapshot. ``run()`` returns ``(engine, history)``; completed tokens
    are ``engine.batcher.results()``, expired/failed requests
    ``engine.batcher.failures()``.

    ``group``: the rank's :class:`~repro_torch.dist.group.SeqGroup` when
    the engine is one rank of a sequence-parallel engine; its snapshots
    then go to ``ckpt_dir/rank{index}``.
    """

    def __init__(self, make_engine: Callable, params, ckpt_dir: str, *,
                 checkpoint_every: int = 4, max_restarts: int = 4,
                 backoff: float = 0.0, keep: int = 3,
                 injector=None, watchdog: Optional[StragglerWatchdog] = None,
                 timer: Callable[[], float] = time.perf_counter,
                 max_steps: Optional[int] = None,
                 obs: Optional[Observability] = None,
                 on_step: Optional[Callable[[Any, dict], None]] = None,
                 group=None):
        self.make_engine = make_engine
        self.params = params
        if group is not None:      # one snapshot directory per rank
            ckpt_dir = os.path.join(ckpt_dir, f"rank{group.index}")
        self.manager = CheckpointManager(ckpt_dir, keep=keep,
                                         async_write=False)
        self.checkpoint_every = checkpoint_every
        self.max_restarts = max_restarts
        self.backoff = backoff
        self.injector = injector
        self.watchdog = watchdog
        self.timer = timer
        self.max_steps = max_steps
        # No explicit obs: adopt the first engine's bundle in _boot, so the
        # supervisor's kill/restore timeline lands in the SAME exported
        # trace as the engine's step spans (the whole point of the track).
        self.obs = obs
        self.on_step = on_step   # (engine, history) after every good step
        self._fresh_metrics = None   # the registry as the first boot left it

    def _boot(self):
        engine = self.make_engine()
        if self.obs is None:
            self.obs = getattr(engine, "obs", None) or Observability()
        restored, ck_step = self.manager.restore_latest(engine.state_dict())
        if restored is not None:
            engine.load_state(restored)
            self.obs.registry.inc("ft_restores")
            self.obs.tracer.instant("ft.restore", track="ft", step=ck_step)
        elif self._fresh_metrics is None:
            self._fresh_metrics = engine.registry.state_dict()
        else:
            # A restart from scratch (no snapshot yet) on a registry shared
            # across engines: the lost steps' counts go, as a restore
            # would drop them, so the counters stay exactly-once.
            engine.registry.load_state(self._fresh_metrics)
        if self.injector is not None:
            self.injector.attach(engine)
        return engine

    def run(self):
        history = {"restarts": 0, "straggler_events": 0, "steps_run": 0,
                   "steps_lost": 0, "max_step_loss": 0, "faults": []}
        engine = self._boot()
        while True:
            step = engine.counters["engine_steps"]
            if self.max_steps is not None \
                    and history["steps_run"] >= self.max_steps:
                break
            try:
                if self.injector is not None:
                    self.injector.before_step(step)
                t0 = self.timer()
                more = engine.step(self.params)
                dt = self.timer() - t0
                if self.watchdog is not None and self.watchdog.observe(dt):
                    history["straggler_events"] += 1
                    self.obs.registry.inc("ft_straggler_events")
                    self.obs.tracer.instant("ft.straggler", track="ft",
                                            step=step,
                                            step_time_s=round(dt, 6))
                history["steps_run"] += 1
                done = engine.counters["engine_steps"]
                if more and self.checkpoint_every \
                        and done % self.checkpoint_every == 0:
                    self.manager.save(engine.state_dict(), done)
                    self.obs.tracer.instant("ft.snapshot", track="ft",
                                            step=done)
                if self.on_step is not None:
                    self.on_step(engine, history)
                if not more:
                    break
            except RECOVERABLE as e:
                history["restarts"] += 1
                history["faults"].append(f"{type(e).__name__}: {e}")
                self.obs.tracer.instant("ft.fault", track="ft", step=step,
                                        kind=type(e).__name__,
                                        message=str(e))
                if history["restarts"] > self.max_restarts:
                    raise RestartsExhausted(
                        f"serving still failing after {self.max_restarts} "
                        f"restarts (last fault: {e})") from e
                _backoff_sleep(self.backoff, history["restarts"])
                done_before = engine.counters["engine_steps"]
                engine = self._boot()
                lost = max(done_before - engine.counters["engine_steps"], 0)
                history["steps_lost"] += lost
                history["max_step_loss"] = max(history["max_step_loss"],
                                               lost)
                # Counters AFTER _boot: load_state wholesale-restores a
                # shared registry, so pre-restore increments would be wiped.
                self.obs.registry.inc("ft_faults", kind=type(e).__name__)
                self.obs.registry.inc("ft_restarts")
                self.obs.registry.inc("ft_steps_lost", lost)
                self.obs.tracer.instant("ft.restart", track="ft",
                                        step=engine.counters["engine_steps"],
                                        steps_lost=lost,
                                        restarts=history["restarts"])
        self.manager.wait()
        return engine, history
