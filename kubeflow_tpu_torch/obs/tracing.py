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

"""Request tracing: propagated context + an in-process span ring buffer.

The port's copy of the reference's ``obs/tracing.py``, whole: the
W3C ``traceparent`` / ``X-Request-Id`` context a request carries from
proxy to server to manager to the decode engine, the span-linkage
args (:func:`span_args`, :func:`root_span_args`), tail sampling
(errors and deadline outcomes always kept), span export for the fleet
collector, and the Chrome-trace dump behind ``/tracez``. Span names
and args are the reference's, so one timeline reads the same
whichever package recorded it.

Fleet assembly contract: every hop's root span also carries its own
``span_id`` and, when the caller sent a ``traceparent``, the caller's
span as ``parent_id``; the manager's per-request trio (``queue_wait``
→ ``batch_assembly`` → ``execute``) links to one ``batch_execute``
span per coalesced model execution through ``args.batch``."""

from __future__ import annotations

import itertools
import json
import os
import random
import threading
import time
from collections import deque
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Optional,
    Tuple,
)

__all__ = [
    "REQUEST_ID_HEADER",
    "TRACEPARENT_HEADER",
    "TRACE_LEG_HEADER",
    "TRACER",
    "TraceContext",
    "Tracer",
    "current_context",
    "current_trace_id",
    "ensure_context",
    "filter_spans",
    "from_grpc_metadata",
    "from_headers",
    "new_context",
    "parse_traceparent",
    "root_span_args",
    "span_args",
    "use_context",
]

REQUEST_ID_HEADER = "X-Request-Id"
TRACEPARENT_HEADER = "traceparent"
#: Leg tag of a multi-leg request (role-split hop, hedge twin, resume
#: replay): same trace id, distinct leg — the assembly layer shows one
#: waterfall with the legs side by side instead of N anonymous trees.
TRACE_LEG_HEADER = "X-KFT-Trace-Leg"

_HEX = "0123456789abcdef"

# Id generation is on the per-request hot path: uuid.uuid4() costs an
# os.urandom syscall per call (~45µs on an old kernel — measured
# 135µs per context, most of the obs overhead budget). Trace ids need
# collision resistance, not cryptographic strength: a Mersenne
# twister seeded once from urandom gives ~2µs ids. getrandbits is a
# single C call, so it's GIL-atomic across request threads.
_rng = random.Random(int.from_bytes(os.urandom(16), "big"))


def _hex128() -> str:
    return f"{_rng.getrandbits(128):032x}"


def _hex64() -> str:
    return f"{_rng.getrandbits(64):016x}"


def _is_hex(s: str, length: int) -> bool:
    return len(s) == length and all(c in _HEX for c in s.lower())


class TraceContext:
    """Immutable-ish propagation context: W3C trace/span ids plus the
    human-greppable request id (the access-log join key).
    ``parent_span_id`` is the CALLER's span id (parsed off the inbound
    ``traceparent``) — the edge that lets the collector rebuild the
    cross-process tree; ``leg`` names which leg of a multi-leg request
    this context rides (empty for single-leg requests)."""

    __slots__ = ("trace_id", "span_id", "request_id",
                 "parent_span_id", "leg")

    def __init__(self, trace_id: str, span_id: str, request_id: str,
                 parent_span_id: Optional[str] = None, leg: str = ""):
        self.trace_id = trace_id
        self.span_id = span_id
        self.request_id = request_id
        self.parent_span_id = parent_span_id
        self.leg = leg

    def child(self, leg: Optional[str] = None) -> "TraceContext":
        """Same trace/request, fresh span id parented on THIS context
        — what each hop sends downstream so parentage is
        reconstructible. ``leg`` tags the downstream hop (role-split
        hop, hedge twin, resume replay); None inherits."""
        return TraceContext(self.trace_id, _hex64(), self.request_id,
                            parent_span_id=self.span_id,
                            leg=self.leg if leg is None else leg)

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def headers(self) -> Dict[str, str]:
        out = {REQUEST_ID_HEADER: self.request_id,
               TRACEPARENT_HEADER: self.traceparent()}
        if self.leg:
            out[TRACE_LEG_HEADER] = self.leg
        return out

    def grpc_metadata(self) -> Tuple[Tuple[str, str], ...]:
        """gRPC metadata keys must be lowercase ASCII."""
        out = (("x-request-id", self.request_id),
               ("traceparent", self.traceparent()))
        if self.leg:
            out += (("x-kft-trace-leg", self.leg),)
        return out

    def __repr__(self) -> str:
        return (f"TraceContext(request_id={self.request_id!r}, "
                f"trace_id={self.trace_id!r})")


def new_context(request_id: Optional[str] = None) -> TraceContext:
    trace_id = _hex128()
    return TraceContext(trace_id, _hex64(),
                        request_id or trace_id[:16])


def span_args(ctx: Optional[TraceContext],
              **extra: Any) -> Dict[str, Any]:
    """The span-linkage args every context-tagged span carries:
    request/trace ids for the grep workflow, ``parent_id`` (= the
    context's own span id) for tree assembly, and the leg tag when the
    request is multi-leg. ``extra`` keys ride along verbatim; a None
    context yields just them (the span is then a documented root —
    scripts/lint.py check_span_discipline enforces the distinction)."""
    args: Dict[str, Any] = dict(extra)
    if ctx is not None:
        args.setdefault("request_id", ctx.request_id)
        args["trace_id"] = ctx.trace_id
        args["parent_id"] = ctx.span_id
        if ctx.leg:
            args.setdefault("leg", ctx.leg)
    return args


def root_span_args(ctx: Optional[TraceContext],
                   **extra: Any) -> Dict[str, Any]:
    """The HOP-ROOT flavor of :func:`span_args`: this span OWNS the
    context's span id (children recorded under the same context
    parent on it) and parents on the inbound caller's span id — the
    cross-process edge of the assembled tree. One helper, used by
    every hop root (HTTP mixin, native gRPC listener, the proxy's
    upstream windows), so a linkage change lands everywhere at
    once."""
    args = span_args(ctx, **extra)
    if ctx is not None:
        args["span_id"] = ctx.span_id
        if ctx.parent_span_id:
            args["parent_id"] = ctx.parent_span_id
        else:
            args.pop("parent_id", None)
    return args


def parse_traceparent(value: str) -> Optional[Tuple[str, str]]:
    """``00-<32 hex>-<16 hex>-<2 hex>`` → (trace_id, span_id), or None
    on anything malformed (a bad header must never 500 a request)."""
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if not (_is_hex(version, 2) and _is_hex(trace_id, 32)
            and _is_hex(span_id, 16) and _is_hex(flags, 2)):
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id.lower(), span_id.lower()


def from_headers(headers) -> Optional[TraceContext]:
    """Context from an HTTP request's headers (any Mapping-with-get,
    e.g. tornado's HTTPHeaders), or None when the request carries
    neither header. Client-supplied ids are capped at 128 chars: the
    id is echoed in response headers, copied into every span's args
    (ring-buffer memory is O(capacity × id size)) and written to each
    access-log line — an unbounded header must not ride that far."""
    request_id = headers.get(REQUEST_ID_HEADER)
    if request_id:
        request_id = str(request_id)[:128]
    leg = headers.get(TRACE_LEG_HEADER)
    leg = str(leg)[:32] if leg else ""
    parent = headers.get(TRACEPARENT_HEADER)
    parsed = parse_traceparent(parent) if parent else None
    if parsed:
        # The inbound traceparent's span id is the CALLER's span — it
        # becomes this hop's parent, and this hop mints its own span
        # id, so the assembled tree has one node per hop instead of N
        # hops claiming one id.
        trace_id, parent_span_id = parsed
        return TraceContext(trace_id, _hex64(),
                            request_id or trace_id[:16],
                            parent_span_id=parent_span_id, leg=leg)
    if request_id:
        ctx = new_context(request_id=request_id)
        ctx.leg = leg
        return ctx
    return None


def ensure_context(headers) -> TraceContext:
    """The edge rule (proxy): adopt the caller's context when present,
    mint a fresh one otherwise — every request downstream of here HAS
    an id."""
    return from_headers(headers) or new_context()


# Per-thread active context — the exemplar hook: a Histogram deep in
# a library can stamp "the current request's trace id" onto the bucket
# it observes without the id being threaded through every call
# signature. Explicit obs_ctx plumbing (manager, engine) stays the
# primary path; this is the fallback for code that has no ctx param.
_ACTIVE = threading.local()


class _UseCtx:
    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx

    def __enter__(self):
        self._prev = getattr(_ACTIVE, "ctx", None)
        _ACTIVE.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        _ACTIVE.ctx = self._prev
        return False


def use_context(ctx: Optional[TraceContext]) -> _UseCtx:
    """Make ``ctx`` the thread's current context for the block."""
    return _UseCtx(ctx)


def current_context() -> Optional[TraceContext]:
    return getattr(_ACTIVE, "ctx", None)


def current_trace_id() -> Optional[str]:
    ctx = getattr(_ACTIVE, "ctx", None)
    return ctx.trace_id if ctx is not None else None


def from_grpc_metadata(metadata: Optional[Iterable]
                       ) -> Optional[TraceContext]:
    """Context from gRPC invocation metadata: an iterable of (key,
    value) pairs (grpcio's context.invocation_metadata())."""
    if metadata is None:
        return None
    found = {}
    for item in metadata:
        key, value = item[0], item[1]
        if key.lower() in ("x-request-id", "traceparent",
                           "x-kft-trace-leg"):
            found[key.lower()] = value
    if "x-request-id" not in found and "traceparent" not in found:
        return None

    class _MD:
        def get(self, name, default=None):
            return found.get(name.lower(), default)

    return from_headers(_MD())


#: Span outcomes ALWAYS retained under tail sampling: errors and the
#: deadline/overload family — exactly the spans an SLO alert sends an
#: operator looking for.
RETAIN_OUTCOMES = frozenset({"error", "expired", "deadline_exceeded",
                             "shed"})


class Tracer:
    """Bounded in-process span recorder.

    ``record()`` appends one finished span (a plain dict, Chrome
    trace-event "X" shape) to a deque with maxlen — O(1), no
    allocation churn beyond the dict itself, oldest spans evicted.
    ``enabled=False`` makes record() a no-op (one attribute read);
    the obs-overhead bench flips exactly this switch.

    **Tail sampling** (:meth:`set_tail_sampling`): at fleet load the
    happy path produces thousands of identical spans per second and
    the ring holds seconds of history — the one slow request an
    exemplar points at is long evicted. With tail sampling on, spans
    are kept by what they turned out to be (hence *tail*-based):
    error/deadline/shed outcomes and the slowest decile per span name
    always land in a separate retained buffer; happy-path spans are
    kept with probability ``keep_prob``. ``/tracez`` stays bounded
    (both buffers have maxlen) but the interesting traces survive
    minutes, not milliseconds.
    """

    def __init__(self, capacity: int = 4096, component: str = ""):
        self.enabled = True
        self.component = component or os.environ.get(
            "KFT_OBS_COMPONENT", "")
        self._pid = os.getpid()
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=int(capacity))
        self._batch_ids = itertools.count(1)
        # Tail-sampling state (None = off, the default: record() then
        # costs exactly what it did before the feature existed).
        self._tail_keep_prob: Optional[float] = None
        self._retained: deque = deque(maxlen=int(capacity))
        self._slow_quantile = 0.9
        self._durations: Dict[str, deque] = {}
        self._dur_seen: Dict[str, int] = {}
        self._slow_thr: Dict[str, float] = {}
        # Span-shipping export queue (None = off, the default): every
        # stored span is ALSO appended here for a SpanShipper to drain
        # and push to the fleet collector. Bounded (oldest dropped,
        # counted) so a dead collector can never grow this process.
        self._export: Optional[deque] = None
        self._export_dropped = 0
        #: Called (outside the lock) when the export queue crosses
        #: half capacity — the shipper's wake-early hook, so buffer
        #: pressure ships spans before the ring evicts them.
        self.on_export_pressure: Optional[Callable[[], None]] = None

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._spans = deque(self._spans, maxlen=int(capacity))

    def set_tail_sampling(self, keep_prob: Optional[float], *,
                          retained_capacity: Optional[int] = None,
                          slow_quantile: float = 0.9) -> None:
        """Enable tail-based retention (``keep_prob`` = probability a
        happy-path span is kept; errors and the slowest
        ``1-slow_quantile`` fraction per span name are always kept in
        a separate bounded buffer). ``None`` turns it off."""
        if keep_prob is not None and not (0.0 <= keep_prob <= 1.0):
            raise ValueError("keep_prob must be in [0, 1]")
        if not (0.0 < slow_quantile < 1.0):
            raise ValueError("slow_quantile must be in (0, 1)")
        with self._lock:
            self._tail_keep_prob = keep_prob
            self._slow_quantile = slow_quantile
            if retained_capacity is not None:
                self._retained = deque(self._retained,
                                       maxlen=int(retained_capacity))
            if keep_prob is None:
                self._durations.clear()
                self._slow_thr.clear()

    def next_batch_id(self) -> str:
        return f"batch-{self._pid}-{next(self._batch_ids)}"

    # -- span shipping (export queue) ------------------------------------

    def enable_export(self, capacity: int = 2048) -> None:
        """Turn on the export queue: every span record() stores is
        also queued for a shipper to drain (collector push path).
        Bounded — a stalled shipper costs dropped exports, never
        memory."""
        with self._lock:
            self._export = deque(self._export or (),
                                 maxlen=int(capacity))

    def disable_export(self) -> None:
        with self._lock:
            self._export = None
            self._export_dropped = 0

    def drain_export(self) -> List[Dict[str, Any]]:
        """Pop everything queued for shipping (the SpanShipper's
        cycle body). Empty list when export is off."""
        with self._lock:
            if not self._export:
                return []
            out = list(self._export)
            self._export.clear()
        return out

    def export_stats(self) -> Dict[str, int]:
        with self._lock:
            return {"queued": len(self._export or ()),
                    "dropped": self._export_dropped}

    def _export_locked(self, event: Dict[str, Any]) -> bool:
        """Queue one stored span for shipping; True when the queue
        crossed half capacity (caller fires the pressure hook outside
        the lock)."""
        q = self._export
        if q is None:
            return False
        if len(q) == q.maxlen:
            self._export_dropped += 1
        q.append(event)
        return len(q) * 2 >= (q.maxlen or 1)

    def _classify_locked(self, name: str, dur_s: float,
                         args: Optional[Dict[str, Any]]) -> Optional[str]:
        """Tail-sampling verdict: "error" / "slow" (→ retained
        buffer), None (→ ring, subject to keep_prob). Caller holds
        the lock. The slow threshold is the per-name duration decile
        over a sliding window of recent spans, recomputed every 32
        observations (sorting 128 floats amortized — not per span)."""
        outcome = (args or {}).get("outcome")
        if outcome in RETAIN_OUTCOMES:
            return "error"
        window = self._durations.get(name)
        if window is None:
            window = deque(maxlen=128)
            self._durations[name] = window
        window.append(dur_s)
        # Recompute the decile every 32 observations (a lifetime
        # counter, NOT len(window) — once the window is full its
        # length pins at maxlen and a len-based trigger would sort on
        # every record).
        seen = self._dur_seen.get(name, 0) + 1
        self._dur_seen[name] = seen
        if seen >= 16 and seen % 32 == 0:
            ranked = sorted(window)
            self._slow_thr[name] = ranked[
                min(len(ranked) - 1,
                    int(self._slow_quantile * len(ranked)))]
        thr = self._slow_thr.get(name)
        # Strictly above the decile: a workload whose durations are
        # all identical has no tail, and >= would retain every span.
        if thr is not None and dur_s > thr:
            return "slow"
        return None

    def record(self, name: str, cat: str, start_s: float, dur_s: float,
               args: Optional[Dict[str, Any]] = None,
               tid: Optional[int] = None) -> None:
        """Record one completed span. ``start_s`` is a
        ``time.monotonic()`` timestamp; durations in seconds. Hot
        path: one dict + one locked deque append, no formatting —
        rounding/pretty-printing happens at export time."""
        if not self.enabled:
            return
        event = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": start_s * 1e6,               # µs, Chrome contract
            "dur": dur_s * 1e6 if dur_s > 0.0 else 0.0,
            "pid": self._pid,
            "tid": (tid if tid is not None
                    else threading.get_ident() & 0x7FFFFFFF),
        }
        if args:
            event["args"] = args
        pressure = False
        with self._lock:
            if self._tail_keep_prob is None:
                self._spans.append(event)
                pressure = self._export_locked(event)
            else:
                verdict = self._classify_locked(name, dur_s, args)
                if verdict is not None:
                    args = dict(args or ())
                    args["retain"] = verdict
                    event["args"] = args
                    self._retained.append(event)
                    pressure = self._export_locked(event)
                elif (self._tail_keep_prob >= 1.0
                      or _rng.random() < self._tail_keep_prob):
                    self._spans.append(event)
                    pressure = self._export_locked(event)
        if pressure:
            cb = self.on_export_pressure
            if cb is not None:
                try:
                    cb()
                except Exception:  # noqa: BLE001 — a shipper hook bug
                    pass  # must never fail the recording hot path

    class _SpanCtx:
        __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

        def __init__(self, tracer, name, cat, args):
            self._tracer = tracer
            self._name = name
            self._cat = cat
            self._args = args

        def __enter__(self):
            self._t0 = time.monotonic()
            return self

        def __exit__(self, exc_type, exc, tb):
            if exc_type is not None:
                args = dict(self._args or ())
                args["outcome"] = "error"
                self._args = args
            self._tracer.record(self._name, self._cat, self._t0,
                                time.monotonic() - self._t0, self._args)
            return False

    def span(self, name: str, cat: str = "app",
             args: Optional[Dict[str, Any]] = None) -> "Tracer._SpanCtx":
        """Context manager recording one span around a block."""
        return Tracer._SpanCtx(self, name, cat, args)

    def snapshot(self) -> List[Dict[str, Any]]:
        """All live spans (ring + tail-retained), timestamp-ordered —
        one merged timeline whichever buffer a span survived in."""
        with self._lock:
            if not self._retained:
                return list(self._spans)
            spans = list(self._spans) + list(self._retained)
        spans.sort(key=lambda s: s.get("ts", 0.0))
        return spans

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._retained.clear()
            self._durations.clear()
            self._dur_seen.clear()
            self._slow_thr.clear()
            if self._export is not None:
                self._export.clear()

    def export_chrome(self, spans: Optional[List[Dict[str, Any]]] = None
                      ) -> Dict[str, Any]:
        """The Perfetto-openable document: trace events plus a process
        metadata record naming the component. ``spans`` overrides the
        live snapshot (the /tracez handlers pass a filtered list)."""
        events: List[Dict[str, Any]] = []
        if self.component:
            events.append({"name": "process_name", "ph": "M",
                           "pid": os.getpid(),
                           "args": {"name": self.component}})
        events.extend(self.snapshot() if spans is None else spans)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump_jsonl(self, path: str) -> None:
        """One span per line (the CI artifact shape —
        citests/artifacts.py copies these next to the junit XML)."""
        with open(path, "w") as f:
            for span in self.snapshot():
                f.write(json.dumps(span) + "\n")


def filter_spans(spans: Iterable[Dict[str, Any]], *,
                 trace_id: Optional[str] = None,
                 status: Optional[str] = None,
                 min_duration_ms: Optional[float] = None,
                 limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """The ``/tracez`` query filters, shared by the tornado and stdlib
    exposition handlers: a full 4096-span ring serialized per request
    is megabytes of JSON nobody reads — these narrow it to the trace,
    status or latency band the caller is hunting.

    - ``trace_id`` — spans whose args carry this trace (or request) id
      (the exemplar workflow: histogram bucket → exemplar trace id →
      ``/tracez?trace_id=``).
    - ``status`` — ``error`` matches every non-ok outcome (the
      :data:`RETAIN_OUTCOMES` family); any other value matches that
      outcome exactly.
    - ``min_duration_ms`` — spans at least this long.
    - ``limit`` — keep only the NEWEST n after the other filters.
    """
    out = []
    for span in spans:
        args = span.get("args") or {}
        if trace_id is not None:
            if trace_id not in (args.get("trace_id"),
                                args.get("request_id")):
                continue
        if status is not None:
            outcome = args.get("outcome")
            if status == "error":
                if outcome not in RETAIN_OUTCOMES:
                    continue
            elif outcome != status:
                continue
        if min_duration_ms is not None:
            if span.get("dur", 0.0) < min_duration_ms * 1e3:
                continue
        out.append(span)
    if limit is not None and len(out) > max(0, limit):
        # limit=0 must mean "none": out[-0:] would slice the WHOLE
        # list — the exact unbounded dump the filter exists to stop.
        out = out[-limit:] if limit > 0 else []
    return out


#: The process-wide tracer every module records against.
TRACER = Tracer()
