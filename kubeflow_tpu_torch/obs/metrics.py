# Copyright 2026 The kubeflow-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""Prometheus-style metrics: Counter / Gauge / Histogram + exposition.

The port's own copy of ``kubeflow_tpu/obs/metrics.py``, cut to what the
decode engine and the tenancy counters use: the three metric types with
labels, render-time callbacks with owner-checked clears, histogram
exemplars, the registry and its text exposition. The family names and
the rendered text are the reference's, so a scrape reads the same from
either package. (The exposition parser, the JSONL dump and content
negotiation stay in the reference until the server is ported.)

- **Histogram semantics**: buckets are CUMULATIVE (each ``le`` bucket
  counts all observations <= its bound), ``+Inf`` equals ``_count``,
  and ``_sum`` is the raw total.
- **Cardinality**: label names that imply a series per request
  (:data:`FORBIDDEN_LABELS`) are rejected at metric construction.
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "FORBIDDEN_LABELS",
    "Counter",
    "Gauge",
    "Histogram",
    "REGISTRY",
    "Registry",
    "enabled",
    "render",
    "set_enabled",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Label names whose values are per-request/per-object by construction:
#: one time series per request is the classic cardinality explosion.
#: High-cardinality data belongs in spans (obs/tracing.py) and access
#: logs, never in metric labels. Enforced here at construction.
FORBIDDEN_LABELS = frozenset({
    "request_id", "trace_id", "span_id", "batch_id", "pod_uid", "uid",
})

#: Default histogram buckets (seconds-oriented, same as
#: prometheus_client): sub-ms to 10s covers queue waits, dispatches,
#: reconciles and training steps alike.
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)

# Process-wide update switch. One attribute read per update when
# disabled.
_enabled = True


def set_enabled(value: bool) -> None:
    """Globally enable/disable metric UPDATES (registration and
    rendering always work — a disabled registry renders zeros)."""
    global _enabled
    _enabled = bool(value)


def enabled() -> bool:
    return _enabled


def escape_label_value(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def escape_help(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\n", "\\n")


class Registry:
    """A named collection of metric families; renders the exposition.

    ``reset()`` zeroes every value but KEEPS registrations — metric
    objects are module-level singletons bound at import, so dropping
    them from the registry would orphan every instrumented module.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, "_Metric"] = {}

    def register(self, metric: "_Metric") -> None:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None and existing is not metric:
                # Same definition registered twice happens legally
                # when a module body runs as BOTH `pkg.mod` and
                # `__main__` (python -m pkg.mod with a re-exporting
                # __init__): last wins, matching how the re-executed
                # module's objects are the live ones. A DIFFERENT
                # definition under one name is a real bug.
                if (type(existing) is not type(metric)
                        or existing.labelnames != metric.labelnames
                        or existing.help != metric.help
                        or getattr(existing, "buckets", None)
                        != getattr(metric, "buckets", None)):
                    raise ValueError(
                        f"metric {metric.name!r} already registered")
            self._metrics[metric.name] = metric

    def reset(self) -> None:
        """Zero every value IN PLACE (test isolation). Children are
        kept, not dropped: hot-path modules cache child objects at
        construction (e.g. the decode engine binds its counters once) —
        dropping children would orphan those caches, and their later
        updates would silently stop rendering."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m._reset()

    def collect(self) -> List["_Metric"]:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def render(self, openmetrics: bool = False) -> str:
        out: List[str] = []
        for metric in self.collect():
            out.append(f"# HELP {metric.name} {escape_help(metric.help)}")
            out.append(f"# TYPE {metric.name} {metric.type}")
            out.extend(metric._samples(openmetrics=openmetrics))
        if openmetrics:
            # The OpenMetrics terminator: a scraper that sees no EOF
            # treats the scrape as truncated.
            out.append("# EOF")
        return "\n".join(out) + "\n" if out else ""


#: The process-wide default registry every module instruments against.
REGISTRY = Registry()


def render(registry: Optional[Registry] = None,
           openmetrics: bool = False) -> str:
    return (registry or REGISTRY).render(openmetrics=openmetrics)


def _format_value(value: float) -> str:
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _label_str(labelnames: Tuple[str, ...],
               labelvalues: Tuple[str, ...]) -> str:
    if not labelnames:
        return ""
    pairs = ",".join(
        f'{k}="{escape_label_value(v)}"'
        for k, v in zip(labelnames, labelvalues))
    return "{" + pairs + "}"


class _Child:
    """One labeled time series of a family. Holds its own lock: two
    threads bumping different children never contend."""

    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def reset(self) -> None:
        """Zero the stored value (render callbacks are live state and
        survive — they read the world, not this counter)."""
        with self._lock:
            self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value += amount

    def set(self, value: float) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value = float(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Read the value from ``fn`` at render time (bridges existing
        counters/queues without double bookkeeping). The callback must
        be cheap and thread-safe; a raising callback renders 0 rather
        than failing the whole scrape."""
        with self._lock:
            self._fn = fn

    def clear_function(self, owner: Any = None) -> None:
        """Drop the render-time callback — a bound-method callback on
        a registry-lifetime metric otherwise pins its object (and
        everything it references) forever. With ``owner``, clears only
        if the current callback is a method bound to that object, so a
        stopped instance never clobbers a newer instance's binding."""
        with self._lock:
            if self._fn is None:
                return
            if (owner is not None
                    and getattr(self._fn, "__self__", None)
                    is not owner):
                return
            self._fn = None

    def get(self) -> float:
        with self._lock:
            if self._fn is not None:
                try:
                    return float(self._fn())
                except Exception:  # noqa: BLE001 — never fail a scrape
                    return 0.0
            return self._value


class _Metric:
    type = "untyped"

    def __init__(self, name: str, help: str,  # noqa: A002 — prom idiom
                 labelnames: Iterable[str] = (),
                 registry: Optional[Registry] = REGISTRY):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        labelnames = tuple(labelnames)
        for label in labelnames:
            if not _LABEL_RE.match(label) or label.startswith("__"):
                raise ValueError(f"invalid label name {label!r}")
            if label in FORBIDDEN_LABELS:
                raise ValueError(
                    f"label {label!r} on metric {name!r} is per-request "
                    f"cardinality — put it in a span or access log, "
                    f"not a metric label")
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._children: Dict[Tuple[str, ...], Any] = {}
        self._children_lock = threading.Lock()
        if registry is not None:
            registry.register(self)

    def _make_child(self):
        return _Child()

    def labels(self, *labelvalues: str, **labelkw: str):
        if labelvalues and labelkw:
            raise ValueError("pass label values positionally OR by name")
        if labelkw:
            try:
                labelvalues = tuple(str(labelkw[k])
                                    for k in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"missing label {e.args[0]!r} for {self.name}"
                    ) from None
            if set(labelkw) - set(self.labelnames):
                raise ValueError(
                    f"unknown labels "
                    f"{sorted(set(labelkw) - set(self.labelnames))}")
        else:
            labelvalues = tuple(str(v) for v in labelvalues)
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes {len(self.labelnames)} label "
                f"values, got {len(labelvalues)}")
        with self._children_lock:
            child = self._children.get(labelvalues)
            if child is None:
                child = self._make_child()
                self._children[labelvalues] = child
            return child

    def _default_child(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; "
                f"use .labels(...)")
        return self.labels()

    def _reset(self) -> None:
        with self._children_lock:
            children = list(self._children.values())
        for child in children:
            child.reset()

    def remove_labels(self, *labelvalues: str) -> None:
        """Drop one labeled child (and everything its callbacks pin).
        For metrics labeled by a CHURNING identity — e.g. per-replica
        pod IPs — the series must leave /metrics when the member
        leaves the fleet, or cardinality and the closure-pinned
        objects grow for process lifetime. No-op when absent."""
        with self._children_lock:
            self._children.pop(tuple(str(v) for v in labelvalues),
                               None)

    def _iter_children(self):
        with self._children_lock:
            return list(self._children.items())

    def _samples(self, openmetrics: bool = False) -> List[str]:
        out = []
        for values, child in sorted(self._iter_children()):
            out.append(f"{self.name}"
                       f"{_label_str(self.labelnames, values)} "
                       f"{_format_value(child.get())}")
        if not out and not self.labelnames:
            out.append(f"{self.name} 0")
        return out


class _CounterChild(_Child):
    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters cannot decrease")
        super().inc(amount)


class Counter(_Metric):
    """Monotonically increasing value. ``inc`` only; negative
    increments raise (a decreasing counter corrupts rate()).
    ``set_function`` bridges pre-existing monotonic counters (e.g.
    an engine's lifetime totals) without double bookkeeping."""

    type = "counter"

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._default_child().set_function(fn)

    def _make_child(self):
        return _CounterChild()


class Gauge(_Metric):
    """A value that goes up and down; supports render-time callbacks
    (``set_function``) for bridging live state (queue depth, breaker
    state) without a write on every change."""

    type = "gauge"

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().inc(-amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._default_child().set_function(fn)


class _HistogramChild:
    __slots__ = ("_lock", "_buckets", "_counts", "_sum", "_count",
                 "_exemplars")

    def __init__(self, buckets: Tuple[float, ...],
                 exemplars: bool = False):
        self._lock = threading.Lock()
        self._buckets = buckets
        self._counts = [0] * len(buckets)
        self._sum = 0.0
        self._count = 0
        # One latest exemplar per bucket (index len(buckets) = +Inf):
        # (trace_id, value, unix_ts). Bounded by bucket count, so
        # exemplar memory can never grow with traffic.
        self._exemplars: Optional[List[Optional[Tuple[str, float,
                                                      float]]]] = (
            [None] * (len(buckets) + 1) if exemplars else None)

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * len(self._buckets)
            self._sum = 0.0
            self._count = 0
            if self._exemplars is not None:
                self._exemplars = [None] * (len(self._buckets) + 1)

    def observe(self, value: float,
                trace_id: Optional[str] = None) -> None:
        if not _enabled:
            return
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            # Per-bucket (non-cumulative) storage: one increment per
            # observe; the render accumulates. O(log n) search.
            i = bisect.bisect_left(self._buckets, value)
            if i < len(self._buckets):
                self._counts[i] += 1
            if trace_id and self._exemplars is not None:
                # The OpenMetrics exemplar: the trace that landed in
                # THIS bucket, latest wins — the join key from "the
                # p99 bucket grew" to the one slow request's spans.
                self._exemplars[i] = (str(trace_id)[:128], value,
                                      time.time())

    def snapshot(self):
        with self._lock:
            exemplars = (list(self._exemplars)
                         if self._exemplars is not None else None)
            return list(self._counts), self._sum, self._count, exemplars


class Histogram(_Metric):
    """Observations bucketed by upper bound. Exposition emits
    CUMULATIVE ``_bucket{le=...}`` samples (``+Inf`` == ``_count``),
    plus ``_sum`` and ``_count`` — the histogram_quantile contract.

    With ``exemplars=True``, ``observe(value, trace_id=...)`` pins the
    trace id to the bucket the observation lands in; the OpenMetrics
    render (``render(openmetrics=True)``) emits it as a bucket
    exemplar, which is how a dashboard jumps from "the deadline bucket
    grew" straight to one retained trace in ``/tracez?trace_id=``.
    The classic 0.0.4 render never carries exemplars (its grammar has
    none), so plain scrapers are unaffected."""

    type = "histogram"

    def __init__(self, name: str, help: str,  # noqa: A002
                 labelnames: Iterable[str] = (),
                 buckets: Iterable[float] = DEFAULT_BUCKETS,
                 registry: Optional[Registry] = REGISTRY,
                 exemplars: bool = False):
        buckets = tuple(sorted(float(b) for b in buckets))
        if not buckets:
            raise ValueError("histogram needs at least one bucket")
        if any(b2 <= b1 for b1, b2 in zip(buckets, buckets[1:])):
            raise ValueError(f"buckets must strictly increase: {buckets}")
        if buckets and buckets[-1] == float("inf"):
            buckets = buckets[:-1]  # +Inf is implicit
        self.buckets = buckets
        self.exemplars = bool(exemplars)
        super().__init__(name, help, labelnames, registry)

    def _make_child(self):
        return _HistogramChild(self.buckets, exemplars=self.exemplars)

    def observe(self, value: float,
                trace_id: Optional[str] = None) -> None:
        self._default_child().observe(value, trace_id=trace_id)

    @staticmethod
    def _exemplar_str(exemplar: Tuple[str, float, float]) -> str:
        trace_id, value, ts = exemplar
        return (f' # {{trace_id="{escape_label_value(trace_id)}"}} '
                f"{_format_value(value)} {ts:.3f}")

    def _samples(self, openmetrics: bool = False) -> List[str]:
        out = []
        for values, child in sorted(self._iter_children()):
            counts, total, count, exemplars = child.snapshot()
            if not openmetrics:
                exemplars = None
            cumulative = 0
            for i, (bound, n) in enumerate(zip(self.buckets, counts)):
                cumulative += n
                labels = _label_str(
                    self.labelnames + ("le",),
                    values + (_format_value(bound),))
                suffix = (self._exemplar_str(exemplars[i])
                          if exemplars and exemplars[i] else "")
                out.append(
                    f"{self.name}_bucket{labels} {cumulative}{suffix}")
            labels = _label_str(self.labelnames + ("le",),
                                values + ("+Inf",))
            suffix = (self._exemplar_str(exemplars[-1])
                      if exemplars and exemplars[-1] else "")
            out.append(f"{self.name}_bucket{labels} {count}{suffix}")
            base = _label_str(self.labelnames, values)
            out.append(f"{self.name}_sum{base} {_format_value(total)}")
            out.append(f"{self.name}_count{base} {count}")
        return out
