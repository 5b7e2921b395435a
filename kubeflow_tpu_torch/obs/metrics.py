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

"""Prometheus-style metrics: counters, gauges, histograms, exposition.

The port's copy of the reference's ``obs/metrics.py``, whole, so a
scrape of a port replica reads the same as one of a JAX replica:

- **Text exposition format**: one ``# HELP`` + ``# TYPE`` block per
  family, samples as ``name{label="value"} <float>``, label values
  escaped (``\\\\`` ``\\"`` ``\\n``), HELP text escaped.
  :func:`parse_exposition` is the strict inverse.
- **Histograms**: cumulative ``_bucket{le=...}`` series (each bucket
  counts all observations <= its bound), ``+Inf`` equals ``_count``,
  ``_sum`` is the raw total; exemplars ride the OpenMetrics form only
  (:func:`negotiate_content_type`).
- **Cardinality**: label names that imply a series per request
  (:data:`FORBIDDEN_LABELS`) are rejected at metric construction."""

from __future__ import annotations

import bisect
import json
import re
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "CONTENT_TYPE",
    "CONTENT_TYPE_OPENMETRICS",
    "FORBIDDEN_LABELS",
    "Counter",
    "Gauge",
    "Histogram",
    "REGISTRY",
    "Registry",
    "counter_increase",
    "dump_jsonl",
    "enabled",
    "negotiate_content_type",
    "parse_exposition",
    "render",
    "set_enabled",
]

#: The Prometheus text exposition content type (format version 0.0.4).
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: The OpenMetrics text content type — the format that carries
#: exemplars. Served only when the scraper ASKS for it via Accept
#: (see :func:`negotiate_content_type`); everything else gets 0.0.4.
CONTENT_TYPE_OPENMETRICS = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8")


def negotiate_content_type(accept: Optional[str]) -> str:
    """Scrape-handler content negotiation: OpenMetrics when the
    client's ``Accept`` names it, Prometheus text 0.0.4 otherwise —
    the fallback ladder real Prometheus servers use. Exemplars only
    ride the OpenMetrics form (the 0.0.4 grammar has no ``#`` exemplar
    clause, and a strict 0.0.4 parser would reject it)."""
    if accept and "application/openmetrics-text" in accept:
        return CONTENT_TYPE_OPENMETRICS
    return CONTENT_TYPE


def counter_increase(prev: float, cur: float) -> float:
    """Increase of a cumulative counter between two samples, aware of
    process restarts: a counter that DROPPED was reset to zero (the
    replica restarted) and has climbed back to ``cur`` — the increase
    since the previous sample is at least ``cur``, never the negative
    delta. One shared helper for every rate() computed from scraped
    counters (the collector's store and the autoscaler's shed-rate
    differencing both ride this; a naive subtraction turns one
    replica restart into a huge negative rate)."""
    if cur >= prev:
        return cur - prev
    return max(0.0, cur)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Label names whose values are per-request/per-object by construction:
#: one time series per request is the classic cardinality explosion.
#: High-cardinality data belongs in spans (obs/tracing.py) and access
#: logs, never in metric labels. Enforced here at construction AND
#: statically by scripts/lint.py check_metric_label_discipline.
FORBIDDEN_LABELS = frozenset({
    "request_id", "trace_id", "span_id", "batch_id", "pod_uid", "uid",
})

#: Default histogram buckets (seconds-oriented, same as
#: prometheus_client): sub-ms to 10s covers queue waits, dispatches,
#: reconciles and training steps alike.
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)

# Process-wide update switch (the obs-overhead bench measures with
# this on vs off). One attribute read per update when disabled.
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
        construction (e.g. ServedModel binds its shed counter once) —
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
    the workqueue's lifetime totals) without double bookkeeping."""

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


# -- parsing (the test-side validator) ---------------------------------------


def _unescape_label_value(value: str) -> str:
    out = []
    i = 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            if nxt == "n":
                out.append("\n")
            elif nxt in ("\\", '"'):
                out.append(nxt)
            else:
                raise ValueError(f"bad escape \\{nxt} in label value")
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_labels(text: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    i = 0
    while i < len(text):
        eq = text.index("=", i)
        name = text[i:eq].strip().lstrip(",").strip()
        if not _LABEL_RE.match(name):
            raise ValueError(f"bad label name {name!r}")
        if text[eq + 1] != '"':
            raise ValueError(f"label value for {name} not quoted")
        j = eq + 2
        raw = []
        while True:
            if j >= len(text):
                raise ValueError("unterminated label value")
            if text[j] == "\\":
                raw.append(text[j:j + 2])
                j += 2
                continue
            if text[j] == '"':
                break
            raw.append(text[j])
            j += 1
        labels[name] = _unescape_label_value("".join(raw))
        i = j + 1
    return labels


def _parse_exemplar(blob: str, lineno: int) -> Tuple[Dict[str, str],
                                                     float,
                                                     Optional[float]]:
    """Parse the OpenMetrics exemplar clause ``{labels} value [ts]``
    (the part after the sample's `` # `` separator)."""
    m = re.match(r"^\{(.*)\}\s+(\S+)(?:\s+(\S+))?$", blob.strip())
    if not m:
        raise ValueError(f"line {lineno}: malformed exemplar {blob!r}")
    label_blob, value_text, ts_text = m.groups()
    labels = _parse_labels(label_blob) if label_blob else {}
    try:
        value = float(value_text)
        ts = float(ts_text) if ts_text is not None else None
    except ValueError:
        raise ValueError(
            f"line {lineno}: bad exemplar value in {blob!r}") from None
    return labels, value, ts


def parse_exposition(text: str) -> Dict[str, Dict[str, Any]]:
    """Strictly parse Prometheus text exposition (0.0.4 and the
    OpenMetrics text extensions: bucket exemplars, ``# EOF``). Returns
    ``{family: {"help", "type", "samples": [(name, labels, value)],
    "exemplars": [(name, labels, ex_labels, ex_value, ex_ts)]}}``.

    Raises ValueError on: samples before their family's TYPE line,
    malformed label quoting/escapes, non-float values, histogram
    bucket counts that are not monotonically non-decreasing in
    ``le``-order, or ``+Inf`` != ``_count``. This is the validator
    the endpoint tests run every scrape surface through, and the
    collector's ingest front end.
    """
    families: Dict[str, Dict[str, Any]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            families.setdefault(name, {"help": None, "type": None,
                                       "samples": [], "exemplars": []})
            families[name]["help"] = help_text
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, mtype = rest.partition(" ")
            if mtype not in ("counter", "gauge", "histogram", "summary",
                            "untyped"):
                raise ValueError(f"line {lineno}: unknown type {mtype!r}")
            families.setdefault(name, {"help": None, "type": None,
                                       "samples": [], "exemplars": []})
            families[name]["type"] = mtype
            continue
        if line.startswith("#"):
            continue  # comment (includes the OpenMetrics "# EOF")

        def try_sample(candidate: str):
            # Sample line: name[{labels}] value. Returns the parsed
            # triple, or an error string when the candidate doesn't
            # parse as one (kept so the final diagnostic can name the
            # real problem, e.g. "bad value").
            m = re.match(
                r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)$",
                candidate)
            if not m:
                return None, f"malformed sample {candidate!r}"
            name, label_blob, value_text = m.groups()
            try:
                labels = (_parse_labels(label_blob[1:-1])
                          if label_blob else {})
            except ValueError as e:
                return None, str(e)
            try:
                value = float(value_text.replace("+Inf", "inf")
                              .replace("-Inf", "-inf"))
            except ValueError:
                return None, f"bad value {value_text!r}"
            return (name, labels, value), None

        # OpenMetrics exemplar clause rides after " # " on a sample
        # line — but a LABEL VALUE may legally contain " # " too, so
        # try the whole line as a plain sample first, then each split
        # point left to right (the first left side that parses as a
        # sample wins; anything right of it is the exemplar).
        exemplar_blob = None
        parsed, error = try_sample(line)
        if parsed is None:
            idx = line.find(" # ")
            while idx != -1 and parsed is None:
                parsed, _ = try_sample(line[:idx])
                if parsed is not None:
                    exemplar_blob = line[idx + 3:]
                idx = line.find(" # ", idx + 1)
        if parsed is None:
            raise ValueError(f"line {lineno}: {error}")
        sample_name, labels, value = parsed
        family = sample_name
        for suffix in ("_bucket", "_sum", "_count"):
            base = sample_name[:-len(suffix)] \
                if sample_name.endswith(suffix) else None
            if base and base in families:
                family = base
                break
        if family not in families or families[family]["type"] is None:
            raise ValueError(
                f"line {lineno}: sample {sample_name} precedes its "
                f"# TYPE line")
        families[family]["samples"].append((sample_name, labels, value))
        if exemplar_blob is not None:
            ex_labels, ex_value, ex_ts = _parse_exemplar(
                exemplar_blob, lineno)
            families[family]["exemplars"].append(
                (sample_name, labels, ex_labels, ex_value, ex_ts))
    _validate_histograms(families)
    return families


def _validate_histograms(families: Dict[str, Dict[str, Any]]) -> None:
    for name, fam in families.items():
        if fam["type"] != "histogram":
            continue
        # Group buckets by their non-le label set.
        series: Dict[Tuple, List[Tuple[float, float]]] = {}
        counts: Dict[Tuple, float] = {}
        for sample_name, labels, value in fam["samples"]:
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            if sample_name == f"{name}_bucket":
                le = labels.get("le")
                if le is None:
                    raise ValueError(f"{name}_bucket sample without le")
                bound = float("inf") if le == "+Inf" else float(le)
                series.setdefault(key, []).append((bound, value))
            elif sample_name == f"{name}_count":
                counts[key] = value
        for key, buckets in series.items():
            buckets.sort()
            last = -1.0
            for bound, value in buckets:
                if value < last:
                    raise ValueError(
                        f"{name}: bucket counts not cumulative at "
                        f"le={bound}")
                last = value
            if buckets[-1][0] != float("inf"):
                raise ValueError(f"{name}: missing le=+Inf bucket")
            if key in counts and buckets[-1][1] != counts[key]:
                raise ValueError(
                    f"{name}: +Inf bucket {buckets[-1][1]} != _count "
                    f"{counts[key]}")


def dump_jsonl(path: str, registry: Optional[Registry] = None) -> None:
    """Write every sample as one JSON object per line (the CI artifact
    shape — citests/artifacts.py copies these next to the junit XML)."""
    reg = registry or REGISTRY
    with open(path, "w") as f:
        for metric in reg.collect():
            for line in metric._samples():
                m = re.match(
                    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)$",
                    line)
                if not m:
                    continue
                name, label_blob, value = m.groups()
                f.write(json.dumps({
                    "name": name,
                    "labels": (_parse_labels(label_blob[1:-1])
                               if label_blob else {}),
                    "value": float(value.replace("+Inf", "inf")
                                   .replace("-Inf", "-inf")),
                    "type": metric.type,
                }) + "\n")
