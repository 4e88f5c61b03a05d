"""Failure taxonomy shared by the training and serving control planes.

The old supervisor loop caught bare ``RuntimeError`` — too narrow to cover
real faults and too broad to distinguish "retry will help" from "retry will
loop forever". This module pins the contract instead:

* :class:`Fault` subclasses are **recoverable**: a restart-from-checkpoint
  has a chance of making progress (the fault is transient — a crashed step,
  an injected failure, resource pressure that drains over time). Supervisors
  (``run_with_restarts``, ``ServeSupervisor``) catch exactly
  :data:`RECOVERABLE` and nothing else, under a bounded restart budget.
* :class:`RestartsExhausted` is **terminal**: the restart budget ran out on
  a deterministically failing step — surfacing the original fault via
  ``__cause__`` instead of looping forever.
* :class:`RejectedRequest` / :class:`QueueFull` are **admission verdicts**,
  not faults: raised synchronously at ``submit`` so the caller (not a
  restart loop) decides what to do — resize, shed load, or retry later.

Every class subclasses ``RuntimeError`` so pre-taxonomy callers that caught
``RuntimeError`` keep working.
"""
from __future__ import annotations


class Fault(RuntimeError):
    """Base of recoverable faults: restart-from-checkpoint may help."""


class StepCrash(Fault):
    """A step function died mid-step (real crash or injected)."""


class ResourceExhausted(Fault):
    """A resource pool (KV pages, ...) could not satisfy a request that
    normally fits — transient pressure, recoverable by backoff/preemption."""


class RestartsExhausted(RuntimeError):
    """Terminal: the supervisor's restart budget ran out. ``__cause__``
    carries the last underlying fault."""


class RejectedRequest(ValueError):
    """Admission verdict at ``submit``: the request can NEVER fit the
    engine's layout/pool — no amount of waiting or preemption helps."""


class QueueFull(RuntimeError):
    """Admission backpressure at ``submit``: the bounded queue is full;
    the caller should shed load or retry later."""


#: What supervisor loops catch. Deliberately NOT bare RuntimeError: a
#: deterministic bug must propagate, not restart forever.
RECOVERABLE = (Fault,)
