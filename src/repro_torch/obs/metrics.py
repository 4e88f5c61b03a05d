"""Metrics registry: labeled counters, gauges, and log-bucketed histograms
with mergeable snapshots.

SALO's whole argument is an accounting argument — speedup comes from knowing
how many tiles, launches, and bytes each hybrid sparse pattern costs — so
the runtime's accounting deserves a first-class home instead of scattered
ad-hoc dicts. This module is that home: a small, dependency-free,
host-side-only registry.

Design constraints (shared with :mod:`repro_torch.obs.trace`):

* **Zero cost on the jitted hot path.** Every mutation here is plain host
  Python on plain host numbers. Nothing in this module touches a JAX array
  or adds a traced operand; instrumented code records AROUND its jitted
  calls (or once at trace time), never inside them.
* **Mergeable snapshots.** :meth:`MetricsRegistry.snapshot` produces a
  pure-JSON dict; :func:`merge_snapshots` is associative and commutative
  (counters/histogram buckets add, gauges combine by max), so per-shard /
  per-restart / per-process snapshots fold in any order — the property the
  test suite pins.
* **Exact state round-trip.** ``state_dict()``/``load_state()`` rebuild the
  registry bit-for-bit (the serving engine rides them through its
  snapshot/restore path, exactly as the old ``counters`` dict did).

Histograms are log-bucketed: bucket ``i`` covers
``[BASE**i, BASE**(i+1))`` with ``BASE = 2**0.25`` (~19 % resolution — at
most ~9 % quantile error at the geometric bucket midpoint), plus exact
min/max/sum/count, so latency percentiles survive merging without storing
samples.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

# ~19% bucket resolution: fine enough for latency percentiles, coarse
# enough that a histogram is a handful of sparse buckets.
BASE = 2.0 ** 0.25
_LOG_BASE = math.log(BASE)
# Values at or below this land in the underflow bucket (perf_counter deltas
# on a busy host bottom out well above a nanosecond).
_FLOOR = 1e-9

COUNTER, GAUGE, HISTOGRAM = "counter", "gauge", "histogram"


def bucket_index(x: float) -> int:
    """Log-bucket index of a positive value (floor of log_BASE)."""
    return int(math.floor(math.log(max(float(x), _FLOOR)) / _LOG_BASE))


def bucket_hi(i: int) -> float:
    """Exclusive upper edge of bucket ``i``."""
    return BASE ** (i + 1)


def _labels_key(label_names: Tuple[str, ...],
                labels: Mapping[str, object]) -> Tuple[str, ...]:
    if set(labels) != set(label_names):
        raise ValueError(
            f"metric labels {sorted(labels)} != declared {list(label_names)}")
    return tuple(str(labels[n]) for n in label_names)


class _Family:
    """One named metric family: kind + label names + per-labelset values."""

    def __init__(self, name: str, kind: str, help: str,
                 label_names: Tuple[str, ...]):
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = label_names
        # counter/gauge: key -> float; histogram: key -> _Hist
        self.values: Dict[Tuple[str, ...], object] = {}


class _Hist:
    """Sparse log-bucketed histogram cell."""

    __slots__ = ("buckets", "count", "sum", "min", "max")

    def __init__(self):
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, x: float) -> None:
        x = float(x)
        i = bucket_index(x)
        self.buckets[i] = self.buckets.get(i, 0) + 1
        self.count += 1
        self.sum += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)

    def percentile(self, q: float) -> float:
        """Quantile estimate at the geometric midpoint of the covering
        bucket, clamped to the exact observed [min, max]."""
        if self.count == 0:
            return math.nan
        rank = max(1, math.ceil(q * self.count))   # nearest-rank
        seen = 0
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if seen >= rank:
                mid = BASE ** (i + 0.5)
                return min(max(mid, self.min), self.max)
        return self.max

    def to_dict(self) -> dict:
        return {"buckets": {str(i): c for i, c in sorted(self.buckets.items())},
                "count": self.count, "sum": self.sum,
                "min": (None if self.count == 0 else self.min),
                "max": (None if self.count == 0 else self.max)}

    @classmethod
    def from_dict(cls, d: dict) -> "_Hist":
        h = cls()
        h.buckets = {int(i): int(c) for i, c in d["buckets"].items()}
        h.count = int(d["count"])
        h.sum = float(d["sum"])
        h.min = math.inf if d["min"] is None else float(d["min"])
        h.max = -math.inf if d["max"] is None else float(d["max"])
        return h

    def merged(self, other: "_Hist") -> "_Hist":
        out = _Hist()
        out.buckets = dict(self.buckets)
        for i, c in other.buckets.items():
            out.buckets[i] = out.buckets.get(i, 0) + c
        out.count = self.count + other.count
        out.sum = self.sum + other.sum
        out.min = min(self.min, other.min)
        out.max = max(self.max, other.max)
        return out


class MetricsRegistry:
    """Thread-safe registry of counter/gauge/histogram families.

    All mutators take the family name plus keyword labels::

        reg.inc("decode_launches")
        reg.inc("requests_finished", priority=1)
        reg.observe("ttft_s", 0.042, priority=0)
        reg.set("slab_resident_bytes", 1 << 20)
    """

    def __init__(self):
        self._fams: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    # ------------------------- declaration --------------------------- #
    def _family(self, name: str, kind: str, help: str,
                label_names: Iterable[str]) -> _Family:
        label_names = tuple(label_names)
        with self._lock:
            fam = self._fams.get(name)
            if fam is None:
                fam = _Family(name, kind, help, label_names)
                self._fams[name] = fam
            elif fam.kind != kind or fam.label_names != label_names:
                raise ValueError(
                    f"metric {name!r} re-declared as {kind}{label_names} "
                    f"(was {fam.kind}{fam.label_names})")
            return fam

    def counter(self, name: str, help: str = "",
                label_names: Iterable[str] = ()) -> None:
        self._family(name, COUNTER, help, label_names)

    def gauge(self, name: str, help: str = "",
              label_names: Iterable[str] = ()) -> None:
        self._family(name, GAUGE, help, label_names)

    def histogram(self, name: str, help: str = "",
                  label_names: Iterable[str] = ()) -> None:
        self._family(name, HISTOGRAM, help, label_names)

    # -------------------------- mutation ----------------------------- #
    def inc(self, name: str, amount: float = 1.0, **labels) -> None:
        fam = self._family(name, COUNTER, "", tuple(sorted(labels)))
        key = _labels_key(fam.label_names, labels)
        with self._lock:
            fam.values[key] = fam.values.get(key, 0.0) + amount

    def set(self, name: str, value: float, **labels) -> None:
        fam = self._family(name, GAUGE, "", tuple(sorted(labels)))
        key = _labels_key(fam.label_names, labels)
        with self._lock:
            fam.values[key] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        fam = self._family(name, HISTOGRAM, "", tuple(sorted(labels)))
        key = _labels_key(fam.label_names, labels)
        with self._lock:
            h = fam.values.get(key)
            if h is None:
                h = fam.values[key] = _Hist()
            h.record(value)

    def set_counter(self, name: str, value: float, **labels) -> None:
        """Restore-path escape hatch: set a counter's absolute total (the
        snapshot/restore contract needs exact round-trips, not monotone
        increments)."""
        fam = self._family(name, COUNTER, "", tuple(sorted(labels)))
        key = _labels_key(fam.label_names, labels)
        with self._lock:
            fam.values[key] = float(value)

    # --------------------------- reading ----------------------------- #
    def value(self, name: str, **labels) -> float:
        fam = self._fams[name]
        v = fam.values.get(_labels_key(fam.label_names, labels), 0.0)
        if isinstance(v, _Hist):
            raise TypeError(f"{name} is a histogram; use hist()")
        return v

    def hist(self, name: str, **labels) -> Optional[_Hist]:
        fam = self._fams.get(name)
        if fam is None:
            return None
        return fam.values.get(_labels_key(fam.label_names, labels))

    def percentiles(self, name: str, qs: Iterable[float] = (0.5, 0.9, 0.99),
                    **labels) -> Dict[str, float]:
        """``{"p50": ..., "mean": ..., "count": ...}`` for one histogram
        cell (NaN percentiles / zero count when nothing was observed)."""
        h = self.hist(name, **labels) or _Hist()
        out = {f"p{q * 100:g}": h.percentile(q) for q in qs}
        out["mean"] = h.sum / h.count if h.count else math.nan
        out["count"] = h.count
        return out

    def total(self, name: str) -> float:
        """Sum of a counter/gauge family across ALL label sets (0.0 when the
        family doesn't exist yet — summary lines read metrics that may not
        have fired)."""
        fam = self._fams.get(name)
        if fam is None:
            return 0.0
        if fam.kind == HISTOGRAM:
            raise TypeError(f"{name} is a histogram; use merged_hist()")
        with self._lock:
            return float(sum(fam.values.values()))

    def merged_hist(self, name: str) -> "_Hist":
        """One histogram folding ALL label sets of a family together (empty
        when the family doesn't exist) — e.g. TTFT over every priority."""
        out = _Hist()
        fam = self._fams.get(name)
        if fam is None or fam.kind != HISTOGRAM:
            return out
        with self._lock:
            for h in fam.values.values():
                out = out.merged(h)
        return out

    def families(self) -> List[str]:
        return sorted(self._fams)

    def label_sets(self, name: str) -> List[Tuple[str, ...]]:
        fam = self._fams.get(name)
        return sorted(fam.values) if fam else []

    # ------------------- snapshot / merge / restore ------------------- #
    def snapshot(self) -> dict:
        """Pure-JSON image of the whole registry (also the state_dict)."""
        with self._lock:
            out = {}
            for name, fam in sorted(self._fams.items()):
                cells = {}
                for key, v in sorted(fam.values.items()):
                    k = json.dumps(list(key))
                    cells[k] = v.to_dict() if isinstance(v, _Hist) else v
                out[name] = {"kind": fam.kind, "help": fam.help,
                             "labels": list(fam.label_names),
                             "cells": cells}
            return out

    state_dict = snapshot

    def load_state(self, snap: dict) -> None:
        """Exact wholesale restore from a :meth:`snapshot` image."""
        with self._lock:
            self._fams = {}
        for name, fd in snap.items():
            fam = self._family(name, fd["kind"], fd.get("help", ""),
                               tuple(fd["labels"]))
            for k, v in fd["cells"].items():
                key = tuple(json.loads(k))
                fam.values[key] = (_Hist.from_dict(v)
                                   if fd["kind"] == HISTOGRAM else float(v))

    def merge(self, snap: dict) -> None:
        """Fold a snapshot into the live registry (counter/bucket adds,
        gauge max) — how per-shard or per-restart registries combine."""
        self.load_state(merge_snapshots(self.snapshot(), snap))

    def to_json(self, **dump_kw) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, **dump_kw)


def merge_snapshots(a: dict, b: dict) -> dict:
    """Associative + commutative merge of two :meth:`snapshot` images:
    counters and histogram buckets add, gauges combine by max (the only
    order-free gauge semantics without timestamps)."""
    out = json.loads(json.dumps(a))   # deep copy, stays pure-JSON
    for name, fb in b.items():
        fa = out.get(name)
        if fa is None:
            out[name] = json.loads(json.dumps(fb))
            continue
        if fa["kind"] != fb["kind"] or fa["labels"] != fb["labels"]:
            raise ValueError(f"cannot merge metric {name!r}: "
                             f"{fa['kind']}{fa['labels']} vs "
                             f"{fb['kind']}{fb['labels']}")
        for k, v in fb["cells"].items():
            if k not in fa["cells"]:
                fa["cells"][k] = json.loads(json.dumps(v))
            elif fa["kind"] == COUNTER:
                fa["cells"][k] += v
            elif fa["kind"] == GAUGE:
                fa["cells"][k] = max(fa["cells"][k], v)
            else:
                fa["cells"][k] = _Hist.from_dict(fa["cells"][k]).merged(
                    _Hist.from_dict(v)).to_dict()
    return out


# One process-wide registry for call sites with no engine to hang state on
# (kernel wrappers record their trace-time launch accounting here).
_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    return _GLOBAL
