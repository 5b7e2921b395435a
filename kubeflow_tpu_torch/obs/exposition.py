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

"""Scrape surfaces + structured access logs.

Three delivery mechanisms for the same registry/tracer:

- :class:`MetricsHandler` / :class:`ChromeTraceHandler` — tornado
  routes for the processes that already run tornado (serving server,
  HTTP proxy, dashboard): ``/metrics`` (Prometheus text) and
  ``/tracez`` (Chrome trace JSON).
- :func:`start_exposition_server` — a stdlib ``http.server`` thread
  for the operator (no tornado in its control loop): same two paths
  plus ``/healthz``.
- :func:`access_log_function` — tornado's ``log_function`` hook
  emitting ONE JSON line per request on the ``kft.access`` logger
  (request_id, method, path, status, latency_ms, model, outcome)
  instead of tornado's unstructured access noise. The logger has no
  handler of its own: production mains configure logging and see the
  lines; pytest (which configures nothing) stays quiet.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from kubeflow_tpu_torch.obs import metrics as obs_metrics
from kubeflow_tpu_torch.obs import tracing as obs_tracing

# The tornado handlers are optional: the operator image runs no
# tornado — its scrape surface is the stdlib thread below, and this
# module must import cleanly there (controller.py main imports it).
try:
    import tornado.web as _tornado_web
except ImportError:  # pragma: no cover — serving images ship tornado
    _tornado_web = None

__all__ = [
    "ACCESS_LOGGER",
    "ChromeTraceHandler",
    "MetricsHandler",
    "TraceContextHandlerMixin",
    "access_log_function",
    "start_exposition_server",
]

#: The structured access-log channel. One JSON object per line.
ACCESS_LOGGER = "kft.access"


class TraceContextHandlerMixin:
    """The shared per-request observability behavior of every tornado
    surface (serving server, proxy, dashboard) — mix in BEFORE
    RequestHandler. ``prepare`` adopts/mints the trace context and
    echoes ``X-Request-Id``; ``on_finish`` records one server-side
    span when the subclass opts in via ``_obs_span``. Plain class (no
    tornado dependency): it only touches handler attributes, so it
    imports fine in tornado-less processes too."""

    #: Span name recorded per request; None keeps a handler out of
    #: the ring buffer (health/metrics polls every few seconds would
    #: evict the real request spans).
    _obs_span: Optional[str] = None
    #: Chrome-trace category for this surface's spans.
    _obs_cat = "app"

    def prepare(self) -> None:
        self._obs_ctx = obs_tracing.ensure_context(self.request.headers)
        self._obs_request_id = self._obs_ctx.request_id
        self.set_header(obs_tracing.REQUEST_ID_HEADER,
                        self._obs_ctx.request_id)

    def on_finish(self) -> None:
        if self._obs_span and obs_tracing.TRACER.enabled:
            dur = self.request.request_time()
            ctx = self._obs_ctx
            # The hop's ROOT span: carries its own span id (children
            # recorded under this context parent on it via
            # span_args's parent_id) plus the inbound parent — the
            # linkage the fleet-wide assembly joins on. Model and
            # tenant ride request-root spans only (the tenant value
            # arrives pre-capped via TenantLabelCapper — a
            # key-sprayer cannot explode span cardinality either).
            args = obs_tracing.root_span_args(
                ctx,
                path=self.request.path,
                status=self.get_status(),
                outcome=getattr(self, "_obs_outcome", None)
                or ("ok" if self.get_status() < 400 else "error"))
            model = getattr(self, "_obs_model", None)
            if model:
                args["model"] = model
            tenant = getattr(self, "_obs_tenant", None)
            if tenant:
                args["tenant"] = tenant
            obs_tracing.TRACER.record(
                self._obs_span, self._obs_cat,
                time.monotonic() - dur, dur, args)


def _tracez_filters(get_arg) -> Dict[str, Any]:
    """Parse the shared /tracez query grammar (?trace_id= / ?status= /
    ?min_duration_ms= / ?limit=) from any ``get_arg(name) ->
    Optional[str]``. Raises ValueError on a non-numeric number — the
    handlers answer 400, never 500."""
    filters: Dict[str, Any] = {
        "trace_id": get_arg("trace_id") or None,
        "status": get_arg("status") or None,
        "min_duration_ms": None,
        "limit": None,
    }
    raw = get_arg("min_duration_ms")
    if raw:
        filters["min_duration_ms"] = float(raw)
    raw = get_arg("limit")
    if raw:
        filters["limit"] = int(raw)
    return filters


def _tracez_body(tracer, filters: Dict[str, Any]) -> str:
    spans = obs_tracing.filter_spans(tracer.snapshot(), **filters)
    return json.dumps(tracer.export_chrome(spans=spans))


if _tornado_web is not None:
    class MetricsHandler(_tornado_web.RequestHandler):
        """GET /metrics — Prometheus text exposition of the default
        registry (or a ``metrics_registry`` app setting override).
        Content negotiation: OpenMetrics (with exemplars) when the
        scraper's Accept asks for it, text 0.0.4 otherwise."""

        def get(self):
            registry = self.application.settings.get("metrics_registry")
            ctype = obs_metrics.negotiate_content_type(
                self.request.headers.get("Accept"))
            self.set_header("Content-Type", ctype)
            self.finish(obs_metrics.render(
                registry,
                openmetrics=ctype is obs_metrics
                .CONTENT_TYPE_OPENMETRICS))

    class ChromeTraceHandler(_tornado_web.RequestHandler):
        """GET /tracez — the span ring buffer as Chrome trace-event
        JSON (open in Perfetto / chrome://tracing). Query filters ?trace_id= / ?status= /
        ?min_duration_ms= / ?limit= narrow the dump (a full ring is
        megabytes of JSON; the exemplar workflow lands here with a
        trace id in hand)."""

        def get(self):
            tracer = (self.application.settings.get("tracer")
                      or obs_tracing.TRACER)
            try:
                filters = _tracez_filters(
                    lambda name: self.get_query_argument(name, ""))
            except ValueError as e:
                self.set_status(400)
                return self.finish({"error": str(e)})
            self.set_header("Content-Type", "application/json")
            self.finish(_tracez_body(tracer, filters))
else:  # pragma: no cover — tornado-less images use the stdlib server
    MetricsHandler = ChromeTraceHandler = None


def access_log_function(component: str):
    """Build tornado's ``log_function`` for one component: called once
    per finished request, emits the structured line. Handlers may stash
    ``_obs_request_id`` / ``_obs_model`` / ``_obs_outcome`` attributes
    on themselves to enrich the record."""
    logger = logging.getLogger(ACCESS_LOGGER)

    def log(handler) -> None:
        try:
            record: Dict[str, Any] = {
                "component": component,
                "method": handler.request.method,
                "path": handler.request.uri,
                "status": handler.get_status(),
                "latency_ms": round(
                    handler.request.request_time() * 1e3, 3),
            }
            request_id = getattr(handler, "_obs_request_id", None)
            if request_id:
                record["request_id"] = request_id
            model = getattr(handler, "_obs_model", None)
            if model:
                record["model"] = model
            outcome = getattr(handler, "_obs_outcome", None)
            if outcome:
                record["outcome"] = outcome
            logger.info("%s", json.dumps(record, sort_keys=True))
        except Exception:  # noqa: BLE001 — logging must never 500
            logger.debug("access log failed", exc_info=True)

    return log


#: Push-body ceiling for POST /spans: a batch bigger than this is a
#: misbehaving shipper, not traffic — rejected, never buffered.
MAX_SPAN_PUSH_BYTES = 4 * 1024 * 1024


class _ExpositionHandler(BaseHTTPRequestHandler):
    """stdlib handler: /metrics, /tracez, /healthz — plus, when the
    server carries a ``span_store`` (collector sidecar), the trace
    assembly surface: GET /traces (ids), GET /trace?trace_id= (spans
    + attribution, what ``kft-trace`` reads) and POST /spans (the
    shipper's push path). Server attributes carry the registry/
    tracer/span_store (set by start_exposition_server)."""

    def do_GET(self):  # noqa: N802 — stdlib contract
        path, _, query = self.path.partition("?")
        span_store = getattr(self.server, "span_store", None)
        if path == "/metrics":
            ctype = obs_metrics.negotiate_content_type(
                self.headers.get("Accept"))
            body = obs_metrics.render(
                getattr(self.server, "registry", None),
                openmetrics=ctype is obs_metrics.CONTENT_TYPE_OPENMETRICS
            ).encode()
        elif path == "/tracez":
            from urllib.parse import parse_qs

            tracer = (getattr(self.server, "tracer", None)
                      or obs_tracing.TRACER)
            params = parse_qs(query)
            try:
                filters = _tracez_filters(
                    lambda name: (params.get(name) or [""])[0])
            except ValueError as e:
                self.send_error(400, str(e))
                return
            body = _tracez_body(tracer, filters).encode()
            ctype = "application/json"
        elif path == "/traces" and span_store is not None:
            body = json.dumps(
                {"traces": span_store.trace_ids(),
                 "store": span_store.state()}).encode()
            ctype = "application/json"
        elif path == "/trace" and span_store is not None:
            from urllib.parse import parse_qs

            from kubeflow_tpu_torch.obs import trace as obs_trace

            trace_id = (parse_qs(query).get("trace_id")
                        or [""])[0]
            if not trace_id:
                self.send_error(400, "trace_id is required")
                return
            spans = span_store.trace(trace_id)
            body = json.dumps(
                {"trace_id": trace_id, "spans": spans,
                 "attribution": (obs_trace.attribution(spans)
                                 if spans else None)}).encode()
            ctype = "application/json"
        elif path == "/healthz":
            body = b'{"status": "ok"}'
            ctype = "application/json"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):  # noqa: N802 — stdlib contract
        path, _, _query = self.path.partition("?")
        span_store = getattr(self.server, "span_store", None)
        if path != "/spans" or span_store is None:
            self.send_error(404)
            return
        length = int(self.headers.get("Content-Length") or 0)
        if not 0 < length <= MAX_SPAN_PUSH_BYTES:
            self.send_error(413 if length else 400,
                            "span push body outside bounds")
            return
        try:
            doc = json.loads(self.rfile.read(length))
            spans = doc.get("spans", [])
            if not isinstance(spans, list) or not all(
                    isinstance(s, dict) for s in spans):
                raise ValueError("'spans' must be a list of span "
                                 "objects")
            ingested, dropped = span_store.ingest(
                spans, instance=doc.get("component") or None,
                path="push")
        except (ValueError, TypeError) as e:
            self.send_error(400, f"bad span push: {e}")
            return
        body = json.dumps({"ingested": ingested,
                           "dropped": dropped}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, format, *args):  # noqa: A002 — stdlib sig
        pass  # scrapes every few seconds must not spam stderr


def start_exposition_server(port: int = 0, *,
                            registry: Optional[Any] = None,
                            tracer: Optional[Any] = None,
                            span_store: Optional[Any] = None,
                            host: str = "0.0.0.0"):
    """Serve /metrics + /tracez + /healthz from a daemon thread (the
    operator's scrape surface — it runs no tornado). With a
    ``span_store`` (collector sidecar), also serves the trace
    assembly endpoints (/traces, /trace) and accepts span pushes
    (POST /spans). Returns the ``ThreadingHTTPServer``;
    ``server.server_address[1]`` is the bound port (useful with
    port=0), ``server.shutdown()`` stops it."""
    server = ThreadingHTTPServer((host, port), _ExpositionHandler)
    server.daemon_threads = True
    server.registry = registry
    server.tracer = tracer
    server.span_store = span_store
    thread = threading.Thread(target=server.serve_forever,
                              name="obs-exposition", daemon=True)
    thread.start()
    return server
