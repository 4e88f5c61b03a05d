"""Observability layer: metrics registry + request-lifecycle tracer.

One object, :class:`Observability`, bundles what every instrumented
subsystem needs:

* ``registry`` — a :class:`~repro_torch.obs.metrics.MetricsRegistry` (always
  live: the serving engine's launch/token/page counters are registry
  counters even with tracing off — they replaced the old ad-hoc
  ``ContinuousEngine.counters`` dict and must keep working);
* ``tracer`` — a :class:`~repro_torch.obs.trace.Tracer`; disabled by default
  (``Observability()``), where every span/instant is a host-side no-op.

The hard contract, end to end: **disabled observability is zero-cost on
the device hot path**. All hooks run host-side around the engine's device
calls; no instrumentation adds a kernel launch or a device operand.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from repro_torch.obs.metrics import (MetricsRegistry, global_registry,
                               merge_snapshots)
from repro_torch.obs.trace import NULL_TRACER, Tracer, validate_chrome_trace

__all__ = ["MetricsRegistry", "Observability", "Tracer", "global_registry",
           "merge_snapshots", "summary_line", "validate_chrome_trace"]


def summary_line(registry: MetricsRegistry) -> str:
    """One-line operator summary of the serving/FT metrics that exist so
    far (families that never fired are simply omitted) — the launch
    drivers print this to stderr every ``--summary-every`` steps."""
    t = registry.total
    parts = []
    for label, name in (("steps", "serve_engine_steps"),
                        ("prefill", "serve_prefill_launches"),
                        ("decode", "serve_decode_launches"),
                        ("tok", "serve_decode_tokens"),
                        ("finished", "serve_requests_finished"),
                        ("preempt", "serve_preemptions"),
                        ("expired", "serve_deadline_miss"),
                        ("restarts", "ft_restarts")):
        v = t(name)
        if v or label == "steps":
            parts.append(f"{label}={int(v)}")
    for label, name in (("ttft_p50", "serve_ttft_s"),
                        ("tpot_p50", "serve_tpot_s"),
                        ("qwait_p50", "serve_queue_wait_s")):
        h = registry.merged_hist(name)
        if h.count:
            parts.append(f"{label}={h.percentile(0.5) * 1e3:.2f}ms")
    return " ".join(parts)


class Observability:
    """Registry + tracer bundle threaded through engine/batcher/supervisor.

    ``Observability()`` — metrics only (the default everywhere);
    ``Observability(tracing=True)`` — metrics + span tracing;
    ``clock`` — shared monotonic clock for trace timestamps (inject a fake
    for deterministic traces; the batcher keeps its own injectable clock
    for deadlines).
    """

    def __init__(self, tracing: bool = False, trace_capacity: int = 65536,
                 clock: Callable[[], float] = time.perf_counter,
                 registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = (Tracer(capacity=trace_capacity, clock=clock)
                       if tracing else NULL_TRACER)

    @property
    def tracing(self) -> bool:
        return self.tracer.enabled

    def write_trace(self, path: str) -> None:
        self.tracer.write(path)

    def write_metrics(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.registry.to_json(indent=1))
