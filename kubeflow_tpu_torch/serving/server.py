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

"""The model-server process — tensorflow_model_server's role — on the GPU.

The port's copy of the reference's ``serving/server.py``. A port
replica starts as a JAX one does::

    python -m kubeflow_tpu_torch.serving.server --model_name m \
        --model_base_path /models/m --continuous_batching [--device cpu]

and answers the same REST, SSE and gRPC requests with the same bytes,
so it can stand behind the reference's ``http_proxy`` beside a JAX
replica in one fleet. Models load onto the card (``--device``, default
``cuda``) unless ``--device cpu`` is passed.

Transports, sharing one :class:`~.manager.ModelManager`:
  - native gRPC PredictionService on ``--port`` (default 9000):
    Predict / Classify / GetModelMetadata / GenerateStream
    (serving/grpc_server.py over the wire.py codec);
  - HTTP on ``--rest_port`` (default 8500): TF-Serving REST shapes,
    SSE token streaming, the KV handoff and resume verbs, and the
    PredictionService schema over gRPC-Web.

HTTP endpoints:
  GET  /v1/models/<name>                      → version status
  GET  /v1/models/<name>/metadata             → signature map
  POST /v1/models/<name>[/versions/<v>]:predict   {"instances": ...}
  POST /v1/models/<name>[/versions/<v>]:classify  {"instances": ...}
  POST /v1/models/<name>[/versions/<v>]:generate  {"instances": ...}
  POST /v1/models/<name>[/versions/<v>]:kv/fetch  {"tokens": ...}
  POST /tensorflow.serving.PredictionService/
       (Predict|Classify|GetModelMetadata)           (grpc-web+proto)
  GET  /healthz, /livez, /metrics, /tracez

A stream's ``resume`` event (minted when the caller asks with
``emit_resume``) carries the reference's token; a stream that was
itself resumed adds its original prompt's length (``prompt_len``), so
its next resume is split at the same point (wire.py
``encode_resume_token``).

A gang: started with the launcher's gang env (``KFT_COORDINATOR_ADDRESS``
``host:port``, ``KFT_NUM_PROCESSES``, ``KFT_PROCESS_ID``), every process
joins the group (``training/launcher.py`` ``initialize_distributed``:
gloo with ``--device cpu``, nccl on the cards, a card a rank). Rank 0
is the server: its manager, REST and gRPC listeners, and a sharded
export spanning the gang loads onto the serving mesh. Every other rank
opens no port and runs ``ModelManager.follow()``, loading the same
versions and running their device work, and exits 0 once rank 0 shuts
down."""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import logging
from typing import Any, Dict, Optional

import numpy as np
import tornado.ioloop
import tornado.iostream
import tornado.web

from kubeflow_tpu_torch.obs.exposition import (
    ChromeTraceHandler,
    MetricsHandler,
    TraceContextHandlerMixin,
    access_log_function,
)
from kubeflow_tpu_torch.serving import kv_store, overload, tenancy
from kubeflow_tpu_torch.serving.manager import ModelManager

logger = logging.getLogger(__name__)

# Batcher-await deadline for the gRPC-Web bridge (matches the native
# transport's make_server(timeout_s=...) default).
GRPC_WEB_TIMEOUT_S = 30.0


def _json_default(obj: Any):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    raise TypeError(f"not JSON serializable: {type(obj)}")


class BaseHandler(TraceContextHandlerMixin, tornado.web.RequestHandler):
    # Context adoption/echo + the opt-in per-request span live in the
    # shared mixin (obs/exposition.py); infer-style handlers set
    # _obs_span, health/metrics polls stay out of the ring buffer.
    _obs_cat = "serving"

    @property
    def manager(self) -> ModelManager:
        return self.application.settings["manager"]

    def write_json(self, payload: Dict[str, Any], status: int = 200) -> None:
        self.set_status(status)
        self.set_header("Content-Type", "application/json")
        self.finish(json.dumps(payload, default=_json_default))

    def write_error(self, status_code: int, **kwargs) -> None:
        exc = kwargs.get("exc_info", (None, None, None))[1]
        message = str(exc) if exc else self._reason
        self.finish(json.dumps({"error": message}))


class HealthHandler(BaseHandler):
    """Readiness: 200 only once every model has a loaded version, so
    k8s doesn't route traffic during the (slow) first model load.

    The ready payload also carries per-model saturation signals —
    queue depth, shed/expired counters, the rolling batch-latency
    estimate — so kubelet probes and the dashboard see overload
    building BEFORE requests start failing (a pod at 90% queue is the
    one the autoscaler should act on, not the one already 503ing).

    Schema contract (shared with the proxy's /healthz): ``status``,
    ``saturation`` (per-model batcher signals; empty on the proxy) and
    ``breakers`` (per-upstream circuit-breaker state; empty here — the
    server has no upstreams). ``models`` is kept as a legacy alias of
    ``saturation``."""

    def get(self):
        role = self.application.settings.get("role") or "any"
        if not self.manager.ready():
            return self.write_json(
                {"status": "loading", "saturation": {}, "breakers": {},
                 "role": role}, 503)
        saturation = {}
        for name, model in self.manager.models.items():
            stats = model.batch_stats()
            # Shard topology rides the saturation snapshot (the
            # router/autoscaler/dashboard read it per replica);
            # malformed manifests degrade inside shard_topology, a
            # stub LoadedModel without the method degrades here —
            # /healthz never 500s over a layout summary.
            try:
                default = model.get_resident()
                if default is not None:
                    stats["sharding"] = default.shard_topology()
            except Exception:  # noqa: BLE001 — summary is best-effort
                pass
            saturation[name] = stats
        self.write_json({"status": "ok", "saturation": saturation,
                         "breakers": {}, "models": saturation,
                         "role": role})


class LiveHandler(BaseHandler):
    """Liveness: 200 whenever the process serves HTTP at all."""

    def get(self):
        self.write_json({"status": "alive"})


class StatusHandler(BaseHandler):
    def get(self, name: str):
        try:
            model = self.manager.get_model(name)
        except KeyError as e:
            return self.write_json({"error": e.args[0]}, 404)
        self.write_json({
            "model_version_status": [
                {"version": str(v),
                 "state": "AVAILABLE",
                 "status": {"error_code": "OK"}}
                for v in model.versions
            ]
        })


class MetadataHandler(BaseHandler):
    def get(self, name: str):
        try:
            loaded = self.manager.get_model(name).get()
        except KeyError as e:
            return self.write_json({"error": e.args[0]}, 404)
        self.write_json({
            "model_spec": {"name": name, "version": str(loaded.version)},
            "metadata": loaded.metadata.to_json(),
        })


#: Batcher-await ceiling for deadline-free requests (requests WITH a
#: deadline wait exactly their remaining budget, never this default).
DEFAULT_INFER_WAIT_S = 30.0

#: SSE keepalive cadence: during an inter-token
#: gap longer than this, the stream emits ``: keepalive`` comment
#: frames so intermediaries and clients can tell a slow decode from a
#: wedged stream — and the proxy's inter-chunk-gap tracker gets a
#: bounded healthy ceiling. Comments are invisible to SSE consumers.
SSE_KEEPALIVE_INTERVAL_S = 2.0


async def _await_future(future, wait_s: float):
    """Await a batcher Future ON THE IO LOOP (no pool thread held per
    in-flight request — under overload, a thread-per-wait design turns
    the executor into a hidden second queue whose depth is the pool
    size). asyncio.shield keeps the underlying future un-cancelled on
    timeout: the batcher may still resolve it for a caller that
    already gave up, which is harmless — eviction is the manager's
    job."""
    import asyncio

    try:
        return await asyncio.wait_for(
            asyncio.shield(asyncio.wrap_future(future)), wait_s)
    except asyncio.TimeoutError:
        # Normalize to the concurrent.futures flavor the handlers map
        # to 504/DEADLINE_EXCEEDED (distinct classes until py3.11).
        raise concurrent.futures.TimeoutError(
            "request timed out awaiting the batcher") from None


class InferHandler(BaseHandler):
    _obs_span = "http_request"

    def initialize(self):
        self._live_streams = []
        self._stream_fault = None

    def _register_streams(self, streams) -> None:
        self._live_streams = list(streams)
        # The client may have hung up BEFORE the submit happened (a
        # hedge loser closed during injected latency, a client that
        # gave up in the queue): on_connection_close already fired
        # with nothing registered, so check now — otherwise the
        # decode burns slots into a dead socket.
        conn = getattr(self.request, "connection", None)
        stream = getattr(conn, "stream", None)
        # Tornado nulls connection.stream once the close is handled,
        # so None IS the closed signal here (a live connection always
        # has its stream attached while the handler runs).
        if stream is None or stream.closed():
            for s in self._live_streams:
                s.cancel()

    def on_connection_close(self):
        # A client hung up mid-decode (streaming OR unary-engine —
        # including a hedge loser whose twin already answered): cancel
        # so the engine retires the slot(s) at the next slice boundary
        # instead of decoding into a dead socket until the token
        # budget runs out.
        for stream in self._live_streams:
            stream.cancel()

    async def post(self, name: str, version: Optional[str], verb: str):
        self._obs_model = name
        try:
            model = self.manager.get_model(name)
            # Tenant identity: explicit X-KFT-Tenant, else
            # an X-KFT-Api-Key mapped through the policy, else
            # 'default'. The proxy forwards both headers verbatim, so
            # this server — the layer that owns the queues — is the
            # enforcement point.
            self._tenant = tenancy.tenant_from_headers(
                self.request.headers,
                getattr(self.manager, "tenancy", None))
            # Tenant + model labels ride the request-root span
            # (capped: TenantLabelCapper) so waterfalls filter by
            # tenant.
            self._obs_tenant = tenancy.tenant_label(self._tenant)
            body = json.loads(self.request.body or b"{}")
            instances = body.get("instances")
            handoffs_b64 = body.get("handoffs")
            resume_b64 = body.get("resume")
            prefill_only = bool(body.get("prefill_only"))
            if (prefill_only or handoffs_b64 is not None) \
                    and verb != "generate":
                return self.write_json(
                    {"error": f"KV handoff applies to :generate "
                              f"only, not :{verb}"}, 400)
            if (prefill_only or handoffs_b64 is not None) \
                    and not getattr(model, "continuous_batching",
                                    False):
                # Structured code: the proxy must distinguish "this
                # model/build does not speak the handoff contract"
                # (stop trying — remember it) from a per-request 400
                # (fall back THIS request only). A plain 400 here
                # would poison split routing for the model forever
                # on one client's bad input.
                return self.write_json(
                    {"error": f"model {name!r} is not served with "
                              f"continuous batching; KV handoff "
                              f"rides the decode engine",
                     "code": "UNIMPLEMENTED"}, 400)
            if prefill_only and handoffs_b64 is not None:
                return self.write_json(
                    {"error": "prefill_only and handoffs are "
                              "mutually exclusive"}, 400)
            if resume_b64 is not None and (
                    verb != "generate" or prefill_only
                    or handoffs_b64 is not None):
                return self.write_json(
                    {"error": "decode resume applies to :generate "
                              "alone (no prefill_only/handoffs)"}, 400)
            if resume_b64 is not None \
                    and not getattr(model, "continuous_batching",
                                    False):
                # Same structured code as the handoff contract: the
                # proxy must distinguish "can't ever" from "bad
                # request" when choosing whether to keep trying peers.
                return self.write_json(
                    {"error": f"model {name!r} is not served with "
                              f"continuous batching; decode resume "
                              f"rides the engine",
                     "code": "UNIMPLEMENTED"}, 400)
            if instances is None and handoffs_b64 is None \
                    and resume_b64 is None:
                return self.write_json(
                    {"error": "request body needs 'instances'"}, 400)
            wants_stream = bool(body.get("stream")) or (
                "text/event-stream"
                in self.request.headers.get("Accept", ""))
            if wants_stream and verb != "generate":
                return self.write_json(
                    {"error": f"streaming applies to :generate only, "
                              f"not :{verb}"}, 400)
            if wants_stream and prefill_only:
                return self.write_json(
                    {"error": "prefill_only responses are unary (the "
                              "decode replica streams)"}, 400)
            if resume_b64 is not None and not wants_stream:
                return self.write_json(
                    {"error": "decode resume is a streaming contract "
                              "(set stream: true)"}, 400)
            deadline = overload.request_deadline(self.request.headers,
                                                 body)
            # Fault injection (opt-in, KFT_ENABLE_FAULTS=1 — see
            # serving/faults.py): the same middleware seam on every
            # serving phase; inert (None rule) when unarmed.
            from kubeflow_tpu_torch.serving import faults

            fault_phase = ("resume" if resume_b64 is not None
                           else "handoff" if (prefill_only
                                              or handoffs_b64
                                              is not None)
                           else "stream" if wants_stream else "unary")
            fault_rule = faults.match_request(
                self.application.settings, route=verb, model=name,
                phase=fault_phase)
            if fault_rule is not None and \
                    await faults.inject_request_fault(self, fault_rule):
                self._obs_outcome = "fault_injected"
                return
            self._stream_fault = faults.StreamFaultInjector(
                fault_rule if wants_stream else None)
            want = int(version) if version else None
            # Resident fast path: a dict lookup on the IO loop. Only a
            # cold pinned version goes to a pool thread — get() may
            # load on demand (seconds to minutes of device put +
            # warmup compiles), and under overload an executor hop per
            # request would queue AHEAD of admission control. The
            # deadline bounds even the load wait: a caller with 500ms
            # left gets its 504 at 500ms, not when a 5-minute load
            # finishes (the load itself continues for later callers).
            loaded = model.get_resident(want)
            if loaded is None:
                import asyncio

                load = tornado.ioloop.IOLoop.current().run_in_executor(
                    None, model.get, want)
                try:
                    loaded = await asyncio.wait_for(
                        asyncio.shield(load),
                        overload.clamp_wait_s(deadline,
                                              DEFAULT_INFER_WAIT_S))
                except asyncio.TimeoutError:
                    raise overload.DeadlineExceededError(
                        "model version load did not finish within the "
                        "request budget") from None
            sig_name = body.get("signature_name")
            if resume_b64 is not None:
                return await self._resume_streams(
                    name, model, loaded, resume_b64, body, deadline,
                    want)
            if handoffs_b64 is not None:
                return await self._resume_handoffs(
                    name, model, loaded, handoffs_b64, body, deadline,
                    wants_stream, want)
            sig = loaded.signature(sig_name)
            input_name = next(iter(sig.inputs))
            batch = _instances_to_batch(instances, input_name)
            # Fleet KV pull-through: the proxy names the
            # prefix key's rendezvous owner when this replica isn't
            # it; pull the prefix blocks into the host tier BEFORE
            # paying prefill. Bounded by kv_fetch_deadline_ms and the
            # request budget; every failure silently degrades to the
            # local prefill this path was about to run anyway. Pool
            # thread: the fetch is blocking I/O plus an engine-thread
            # export wait.
            kv_fetch_s = 0.0
            kv_owner = self.request.headers.get(
                kv_store.KV_OWNER_HEADER)
            if kv_owner and verb == "generate":
                prompt = kv_store.prompt_of(instances)
                if prompt is not None:
                    loop = tornado.ioloop.IOLoop.current()
                    kv_fetch_s = await loop.run_in_executor(
                        None, lambda: model.kv_prefetch(
                            prompt, kv_owner, version=want,
                            deadline=deadline))
            if prefill_only:
                return await self._prefill_only(
                    name, model, loaded, {input_name: batch},
                    sig_name, body, deadline, want)
            if wants_stream:
                return await self._stream_generate(
                    name, model, loaded, {input_name: batch},
                    sig_name, want, body, deadline,
                    kv_fetch_s=kv_fetch_s)
            # on_streams registers live engine streams so a client
            # hang-up cancels the UNARY decode too (hedged
            # requests' losers are cancelled by closing this
            # connection; the engine retires the slots at the next
            # slice boundary — white-box visible in its stats).
            future = model.submit({input_name: batch}, sig_name, verb,
                                  want, deadline=deadline,
                                  obs_ctx=self._obs_ctx,
                                  tenant=self._tenant,
                                  on_streams=self._register_streams,
                                  kv_fetch_s=kv_fetch_s)
            # Never hold the connection past the budget.
            result = await _await_future(
                future, overload.clamp_wait_s(deadline,
                                              DEFAULT_INFER_WAIT_S))
            self.write_json({"model_spec": {"name": name,
                                            "version": str(loaded.version)},
                             "predictions": _batch_to_instances(result)})
        except KeyError as e:
            self.write_json({"error": e.args[0]}, 404)
        except ValueError as e:
            self.write_json({"error": str(e)}, 400)
        except overload.DeadlineExceededError as e:
            # The request's own budget lapsed: 504, and the structured
            # code tells retrying gateways NOT to (the deadline is
            # gone whoever retries).
            self._obs_outcome = "expired"
            self.write_json({"error": str(e),
                             "code": "DEADLINE_EXCEEDED"}, 504)
        except overload.QuotaExceededError as e:
            # ONE tenant's bucket ran dry: structured 429,
            # distinct from the global 503 shed — the server has
            # capacity, this tenant spent its share. Retry-After is
            # the bucket's own refill estimate.
            self._obs_outcome = "quota_shed"
            self.set_header("Retry-After",
                            overload.retry_after_header(e.retry_after_s))
            self.write_json({"error": str(e), "tenant": e.tenant,
                             "code": "QUOTA_EXCEEDED"}, 429)
        except overload.OverloadedError as e:
            # Shed by admission control / queue cap: 503 with the
            # server's estimate of when capacity frees up.
            self._obs_outcome = "shed"
            self.set_header("Retry-After",
                            overload.retry_after_header(e.retry_after_s))
            self.write_json({"error": str(e),
                             "code": "RESOURCE_EXHAUSTED"}, 503)
        except (TimeoutError, concurrent.futures.TimeoutError) as e:
            # future.result() outwaited the budget while the request
            # was dispatched (or the 30 s default for deadline-free
            # clients): the work may still complete, but this caller
            # is gone — 504 either way. (Both classes: they are only
            # unified from Python 3.11.)
            self._obs_outcome = "expired"
            self.write_json({"error": str(e) or "request timed out",
                             "code": "DEADLINE_EXCEEDED"}, 504)
        except RuntimeError as e:
            # Shutdown races and other server-side transients: 503 so
            # clients and the gateway retry with backoff instead of
            # treating it as a bad request.
            self.write_json({"error": str(e)}, 503)

    async def _prefill_only(self, name, model, loaded, inputs,
                            sig_name, body, deadline, version=None):
        """The prefill-role half of KV handoff: run the prompt
        prefill(s) and answer with opaque handoff blobs the caller
        relays to a decode-role replica. The device work runs on a
        pool thread (prefill is a real device execution), bounded by the
        request budget like every other wait."""
        import asyncio
        import base64

        from kubeflow_tpu_torch.serving import wire

        max_new = body.get("max_new_tokens")
        if max_new is not None:
            max_new = int(max_new)
        loop = tornado.ioloop.IOLoop.current()
        work = loop.run_in_executor(
            None, lambda: model.prefill_handoff(
                inputs, sig_name, version, deadline=deadline,
                tenant=self._tenant, max_new_tokens=max_new,
                obs_ctx=self._obs_ctx))
        try:
            loaded, handoffs = await asyncio.wait_for(
                asyncio.shield(work),
                overload.clamp_wait_s(deadline, DEFAULT_INFER_WAIT_S))
        except asyncio.TimeoutError:
            raise overload.DeadlineExceededError(
                "prefill did not finish within the request "
                "budget") from None
        self.write_json({
            "model_spec": {"name": name,
                           "version": str(loaded.version)},
            "handoffs": [
                base64.b64encode(wire.encode_kv_handoff(
                    name, loaded.version, h)).decode("ascii")
                for h in handoffs],
        })

    async def _resume_handoffs(self, name, model, loaded,
                               handoffs_b64, body, deadline,
                               wants_stream, version=None):
        """The decode-role half: adopt relayed prefill caches into
        this replica's engine and decode (unary or streamed). A blob
        from another model/version fails 400 — pages from a different
        export would be read as garbage K/V."""
        import base64

        from kubeflow_tpu_torch.serving import wire

        if not isinstance(handoffs_b64, list) or not handoffs_b64:
            return self.write_json(
                {"error": "'handoffs' must be a non-empty list of "
                          "base64 blobs"}, 400)
        try:
            handoffs = [
                wire.decode_kv_handoff(
                    base64.b64decode(blob), model=name,
                    version=loaded.version)
                for blob in handoffs_b64]
        except (ValueError, TypeError) as e:
            return self.write_json(
                {"error": f"bad KV handoff: {e}"}, 400)
        loaded, streams = model.submit_handoff(
            handoffs, version, deadline=deadline,
            obs_ctx=self._obs_ctx, tenant=self._tenant)
        if wants_stream:
            return await self._stream_generate(
                name, model, loaded, None, None, None, body,
                deadline, streams=streams)
        from kubeflow_tpu_torch.serving.manager import _combine_streams

        future = concurrent.futures.Future()
        _combine_streams(streams, future)
        result = await _await_future(
            future, overload.clamp_wait_s(deadline,
                                          DEFAULT_INFER_WAIT_S))
        self.write_json({"model_spec": {"name": name,
                                        "version": str(loaded.version)},
                         "predictions": _batch_to_instances(result)})

    async def _resume_streams(self, name, model, loaded, resume_b64,
                              body, deadline, version=None):
        """Mid-stream decode resume: each row's resume
        token (minted by the dead replica, relayed by the proxy) plus
        the tokens already emitted re-enter THIS replica's engine as
        a continuation — prompt+emitted context, original remaining
        step-key schedule — so the stitched stream is bitwise the
        sequence the dead replica would have produced."""
        import base64

        from kubeflow_tpu_torch.serving import wire

        emitted_rows = body.get("resume_emitted")
        if (not isinstance(resume_b64, list) or not resume_b64
                or not isinstance(emitted_rows, list)
                or len(emitted_rows) != len(resume_b64)):
            return self.write_json(
                {"error": "'resume' needs a non-empty blob list and a "
                          "matching 'resume_emitted' row list"}, 400)
        try:
            resumes = []
            for blob, emitted in zip(resume_b64, emitted_rows):
                token = wire.decode_resume_token(
                    base64.b64decode(blob), model=name,
                    version=loaded.version)
                if not isinstance(emitted, list):
                    raise ValueError("resume_emitted rows must be "
                                     "token lists")
                resumes.append((token, emitted))
        except (ValueError, TypeError) as e:
            return self.write_json(
                {"error": f"bad resume token: {e}"}, 400)
        loaded, streams = model.submit_resume(
            resumes, version, deadline=deadline, obs_ctx=self._obs_ctx,
            tenant=self._tenant)
        return await self._stream_generate(
            name, model, loaded, None, None, None, body, deadline,
            streams=streams)

    async def _stream_generate(self, name, model, loaded, inputs,
                               sig_name, version, body, deadline,
                               streams=None, kv_fetch_s: float = 0.0):
        """SSE token streaming over the continuous-batching engine.

        Wire (serving/wire.py SSE codec):
        ``token`` events as each token is sampled ({row, index,
        token}), ``error`` per failed row ({row, error, code}), one
        terminal ``done`` ({model_spec, tokens: [per-row array or
        null]}). Events flush per engine slice, so time-to-first-token
        is prefill + one slice, not the whole decode. The engine's
        notify hook schedules drains on the IOLoop; awaiting flush()
        keeps slow clients back-pressured instead of buffered."""
        import asyncio

        from kubeflow_tpu_torch.serving import wire

        if streams is None:
            max_new = body.get("max_new_tokens")
            if max_new is not None:
                max_new = int(max_new)
            _, streams = model.submit_stream(
                inputs, sig_name, version, deadline=deadline,
                obs_ctx=self._obs_ctx, tenant=self._tenant,
                max_new_tokens=max_new, kv_fetch_s=kv_fetch_s)
        self._live_streams = streams
        self.set_header("Content-Type", wire.SSE_CONTENT_TYPE)
        self.set_header("Cache-Control", "no-cache")
        self.set_header("X-Accel-Buffering", "no")  # proxies: no buffer
        injector = self._stream_fault
        loop = tornado.ioloop.IOLoop.current()
        signal = asyncio.Event()

        def notify():  # engine thread → IOLoop
            loop.add_callback(signal.set)

        for s in streams:
            s.set_notify(notify)
        finished = [False] * len(streams)
        results: list = [None] * len(streams)

        async def kill_injected() -> None:
            # Injected mid-stream death (faults.py): drop the
            # connection raw — exactly how a crashed replica looks
            # from the proxy — and cancel the decode like the real
            # close handler would.
            for s in streams:
                s.cancel()
            self._obs_outcome = "fault_killed"
            self.request.connection.stream.close()

        try:
            if body.get("emit_resume"):
                # The proxy asked for resume context: one
                # opaque blob per resumable row, minted BEFORE tokens
                # flow so a death at any point is resumable. The
                # proxy strips these; direct clients only see them if
                # they asked.
                import base64 as _b64

                for r, s in enumerate(streams):
                    ctx = getattr(s, "resume_ctx", None)
                    if ctx is None:
                        continue
                    # A resumed stream's context holds its earlier
                    # lives' tokens: prompt_len keeps the split point
                    # for the next replica (no key on a first life,
                    # so its blob is the reference's byte for byte).
                    blob = wire.encode_resume_token(
                        name, int(loaded.version), ctx["prompt"],
                        ctx["step_keys"], ctx["max_new_tokens"],
                        prompt_len=ctx.get("prompt_len"))
                    self.write(wire.format_sse_event(
                        {"row": r, "version": str(loaded.version),
                         "blob": _b64.b64encode(blob).decode("ascii")},
                        event="resume"))
                await self.flush()
            while not all(finished):
                signal.clear()
                wrote = False
                for r, s in enumerate(streams):
                    for ev in s.drain():
                        if injector is not None and injector.rule \
                                is not None:
                            if wrote:
                                # Flush BEFORE the fault point so an
                                # injected kill/stall severs the
                                # stream exactly after the events the
                                # client was shown — how a real crash
                                # looks from the proxy.
                                await self.flush()
                            if await injector.before_event():
                                return await kill_injected()
                        wrote = True
                        if ev.final:
                            finished[r] = True
                            if ev.error is not None:
                                self.write(wire.format_sse_event(
                                    {"row": r, "error": str(ev.error),
                                     "code": _stream_error_code(
                                         ev.error)},
                                    event="error"))
                            else:
                                results[r] = s.result(
                                    timeout=1.0).tolist()
                        else:
                            self.write(wire.format_sse_event(
                                {"row": r, "index": ev.index,
                                 "token": ev.token}, event="token"))
                if wrote:
                    await self.flush()
                if all(finished):
                    break
                # Bounded wait with keepalive comments: the total
                # stall ceiling is unchanged (remaining budget capped
                # at DEFAULT_INFER_WAIT_S), but long inter-token gaps
                # now carry ``: keepalive`` frames so downstream can
                # tell slow from wedged.
                budget = overload.clamp_wait_s(deadline,
                                               DEFAULT_INFER_WAIT_S)
                keepalive_s = self.application.settings.get(
                    "sse_keepalive_s", SSE_KEEPALIVE_INTERVAL_S)
                waited = 0.0
                stalled = False
                while True:
                    step = min(keepalive_s, budget - waited)
                    if step <= 0:
                        stalled = True
                        break
                    try:
                        await asyncio.wait_for(signal.wait(), step)
                        break
                    except asyncio.TimeoutError:
                        waited += step
                        if waited >= budget:
                            stalled = True
                            break
                        self.write(wire.SSE_KEEPALIVE)
                        await self.flush()
                if stalled:
                    for s in streams:
                        s.cancel()
                    self._obs_outcome = "expired"
                    self.write(wire.format_sse_event(
                        {"error": "stream timed out awaiting the "
                                  "engine",
                         "code": "DEADLINE_EXCEEDED"}, event="error"))
                    break
            if injector is not None and await injector.before_event():
                return await kill_injected()
            self.write(wire.format_sse_event(
                {"model_spec": {"name": name,
                                "version": str(loaded.version)},
                 "tokens": results}, event="done"))
            await self.flush()
            self.finish()
        except tornado.iostream.StreamClosedError:
            for s in streams:
                s.cancel()


class KVFetchHandler(BaseHandler):
    """``:kv/fetch`` — the owner side of the fleet KV tier. A peer replica that missed locally POSTs the prompt's token
    ids; this replica walks its engine's prefix chain (device radix
    index, then its host tier) and answers the covered full blocks as
    one opaque wire.py ``kv_blocks`` blob. A clean miss (version not
    resident, no engine yet, zero coverage) is a 200 with
    ``count: 0`` — only malformed requests 400, and the asker treats
    EVERY non-ideal answer as fall-back-to-prefill."""

    _obs_span = "kv_fetch"

    async def post(self, name: str, version: Optional[str]):
        import base64

        from kubeflow_tpu_torch.serving import wire

        self._obs_model = name
        try:
            model = self.manager.get_model(name)
        except KeyError as e:
            return self.write_json({"error": e.args[0]}, 404)
        try:
            body = json.loads(self.request.body or b"{}")
        except json.JSONDecodeError:
            return self.write_json(
                {"error": "request is not valid JSON"}, 400)
        tokens = body.get("tokens")
        try:
            tokens = [int(t) for t in tokens]
        except (TypeError, ValueError):
            tokens = None
        if not tokens:
            return self.write_json(
                {"error": "request body needs 'tokens': a non-empty "
                          "list of token ids"}, 400)
        if not getattr(model, "continuous_batching", False):
            return self.write_json(
                {"error": f"model {name!r} is not served with "
                          f"continuous batching; the fleet KV tier "
                          f"rides the decode engine",
                 "code": "UNIMPLEMENTED"}, 400)
        want = int(version) if version else None
        try:
            # Pool thread: the export waits on the engine thread (the
            # chain walk + page reads must see untorn pages).
            loop = tornado.ioloop.IOLoop.current()
            loaded, blocks = await loop.run_in_executor(
                None, lambda: model.export_kv_blocks(tokens, want))
        except ValueError as e:
            return self.write_json({"error": str(e)}, 400)
        if loaded is None or not blocks:
            self._obs_outcome = "miss"
            return self.write_json({
                "model_spec": {"name": name},
                "blocks": None, "count": 0})
        engine = loaded.engine
        blob = wire.encode_kv_blocks(
            name, int(loaded.version), int(engine.config.page_size),
            blocks)
        self.write_json({
            "model_spec": {"name": name,
                           "version": str(loaded.version)},
            "blocks": base64.b64encode(blob).decode("ascii"),
            "count": len(blocks)})


def _stream_error_code(error: BaseException) -> str:
    if isinstance(error, overload.DeadlineExceededError):
        return "DEADLINE_EXCEEDED"
    if isinstance(error, overload.QuotaExceededError):
        return "QUOTA_EXCEEDED"
    if isinstance(error, overload.OverloadedError):
        return "RESOURCE_EXHAUSTED"
    return "INTERNAL"


def _instances_to_batch(instances: Any, input_name: str) -> np.ndarray:
    """TF-Serving 'row format': instances is a list of rows, each either
    a bare tensor or {input_name: tensor}."""
    if not isinstance(instances, list) or not instances:
        raise ValueError("'instances' must be a non-empty list")
    rows = []
    for row in instances:
        if isinstance(row, dict):
            if input_name not in row:
                raise ValueError(
                    f"instance missing input {input_name!r}")
            rows.append(row[input_name])
        else:
            rows.append(row)
    return np.asarray(rows)


def _batch_to_instances(outputs: Dict[str, np.ndarray]) -> list:
    """Zip output dict-of-batches into a list of per-row dicts (parity:
    the proxy's response shaping, reference server.py:233-236)."""
    keys = sorted(outputs)
    n = len(outputs[keys[0]])
    return [
        {k: outputs[k][i] for k in keys}
        for i in range(n)
    ]


class GrpcWebPredictHandler(BaseHandler):
    """gRPC-Web PredictionService: Predict, Classify, GetModelMetadata.

    POST /tensorflow.serving.PredictionService/<Method> with
    application/grpc-web+proto — the same message schemas the
    reference's gRPC clients speak (inception-client/label.py:40-56);
    Envoy's grpc_web filter bridges browser gRPC-Web clients to these
    over HTTP/1.1 (all three verbs, so the bridged surface equals the
    native :9000 one). The service bodies are shared with the native
    transport (serving/grpc_server.py); only the await style differs.
    """

    _obs_span = "grpc_web_request"

    async def post(self, method: str):
        import base64
        import concurrent.futures

        from kubeflow_tpu_torch.serving import wire

        ctype = self.request.headers.get("Content-Type", "")
        self._text_mode = "-text" in ctype.split(";")[0]
        if not any(ctype.startswith(t)
                   for t in wire.GRPC_WEB_CONTENT_TYPES + (
                       "application/grpc-web-text",)):
            return self.write_json(
                {"error": f"unsupported content-type {ctype!r}"}, 415)
        try:
            from kubeflow_tpu_torch.serving import grpc_server as svc

            body = self.request.body
            if self._text_mode:  # grpc-web-text = base64-wrapped frames
                body = base64.b64decode(body)
            frames = wire.unframe_messages(body)
            data = [m for flags, m in frames if not flags & 0x80]
            if len(data) != 1:
                raise ValueError(f"expected 1 message frame, got {len(data)}")
            # gRPC-Web carries the client deadline as a plain
            # grpc-timeout header (Envoy's grpc_web filter forwards it
            # verbatim); decode it into the same absolute deadline the
            # native listener derives from context.time_remaining().
            deadline = None
            timeout_header = self.request.headers.get("Grpc-Timeout")
            if timeout_header:
                deadline = overload.deadline_after(
                    wire.parse_grpc_timeout(timeout_header))
            # The tenant rides plain HTTP headers on the gRPC-Web
            # bridge, exactly like the REST surface.
            tenant = tenancy.tenant_from_headers(
                self.request.headers,
                getattr(self.manager, "tenancy", None))
            loop = tornado.ioloop.IOLoop.current()
            # start_* resolve the model version, which may load a
            # pinned version on demand — pool thread, not the IO loop.
            if method == "Predict":
                spec, loaded, future, output_filter = (
                    await loop.run_in_executor(
                        None, svc.start_predict, self.manager, data[0],
                        deadline, self._obs_ctx, tenant))
                finish = lambda out: svc.finish_predict(  # noqa: E731
                    spec, loaded, out, output_filter)
            elif method == "Classify":
                spec, loaded, future = await loop.run_in_executor(
                    None, svc.start_classify, self.manager, data[0],
                    deadline, self._obs_ctx, tenant)
                finish = lambda out: svc.finish_classify(  # noqa: E731
                    spec, loaded, out)
            else:  # GetModelMetadata (route regex restricts the set)
                future, finish = None, None
                body = await loop.run_in_executor(
                    None, svc.get_model_metadata, self.manager, data[0])
            if future is not None:
                outputs = await _await_future(
                    future, overload.clamp_wait_s(deadline,
                                                  GRPC_WEB_TIMEOUT_S))
                body = finish(outputs)
            self._grpc_reply(wire.frame_message(body)
                             + wire.trailers_frame(0))
        except KeyError as e:
            self._grpc_error(5, str(e))  # NOT_FOUND
        except ValueError as e:
            self._grpc_error(3, str(e))  # INVALID_ARGUMENT
        except (concurrent.futures.TimeoutError,
                overload.DeadlineExceededError) as e:
            self._grpc_error(4, str(e) or "predict timed out")  # DEADLINE
        except overload.QuotaExceededError as e:
            # gRPC has no 429: RESOURCE_EXHAUSTED with the tenant in
            # the message (the REST surface keeps the distinct code).
            self._grpc_error(8, str(e))
        except overload.OverloadedError as e:
            self._grpc_error(8, str(e))  # RESOURCE_EXHAUSTED
        except RuntimeError as e:
            self._grpc_error(14, str(e))  # UNAVAILABLE
        except Exception as e:  # malformed frames etc. must not 500:
            # gRPC-Web clients can only map grpc-status trailers.
            self._grpc_error(3, f"malformed request: {type(e).__name__}")

    def _grpc_reply(self, payload: bytes) -> None:
        import base64

        if self._text_mode:
            self.set_header("Content-Type",
                            "application/grpc-web-text+proto")
            self.finish(base64.b64encode(payload))
        else:
            self.set_header("Content-Type", "application/grpc-web+proto")
            self.finish(payload)

    def _grpc_error(self, status: int, message: str) -> None:
        from kubeflow_tpu_torch.serving import wire

        self.set_status(200)  # gRPC-Web carries status in trailers
        self._grpc_reply(wire.trailers_frame(
            status, message.replace("\n", " ")))


def _roles():
    """Single-sourced role vocabulary (+ degrade rule) — the endpoint
    registry owns it; the server merely speaks it."""
    from kubeflow_tpu_torch.scaling.endpoints import ROLES, normalize_role

    return ROLES, normalize_role


def make_app(manager: ModelManager,
             role: str = "any",
             fault_plan: Optional[str] = None,
             sse_keepalive_s: float = SSE_KEEPALIVE_INTERVAL_S
             ) -> tornado.web.Application:
    roles, normalize_role = _roles()
    if role not in roles:
        # Tolerate-but-normalize: a mid-rollout flag typo must not
        # take the replica down; it just serves as role-less.
        logger.warning("unknown serving role %r; serving as %r",
                       role, normalize_role(role))
        role = normalize_role(role)
    # Fault injection (serving/faults.py): construction
    # REFUSES without KFT_ENABLE_FAULTS=1 — a fault plan leaking into
    # a production manifest fails the process at startup.
    fault_source = None
    if fault_plan is not None:
        from kubeflow_tpu_torch.serving.faults import FaultPlanSource

        fault_source = FaultPlanSource(fault_plan)
    return tornado.web.Application([
        (r"/healthz", HealthHandler),
        (r"/livez", LiveHandler),
        (r"/metrics", MetricsHandler),
        (r"/tracez", ChromeTraceHandler),
        (r"/v1/models/([^/:]+)", StatusHandler),
        (r"/v1/models/([^/:]+)/metadata", MetadataHandler),
        (r"/v1/models/([^/:]+)(?:/versions/(\d+))?:(predict|classify|generate)",
         InferHandler),
        (r"/v1/models/([^/:]+)(?:/versions/(\d+))?:kv/fetch",
         KVFetchHandler),
        (r"/tensorflow\.serving\.PredictionService/"
         r"(Predict|Classify|GetModelMetadata)",
         GrpcWebPredictHandler),
    ], manager=manager, role=role, fault_source=fault_source,
       sse_keepalive_s=sse_keepalive_s,
       log_function=access_log_function("model-server"))


def load_model_config(path: str):
    """TF-Serving's --model_config_file role, as JSON:
    ``[{"name": ..., "base_path": ..., "max_batch": 64}, ...]``
    (the proto ModelServerConfig's model_config_list fields)."""
    with open(path) as f:
        entries = json.load(f)
    if not isinstance(entries, list) or not entries:
        raise ValueError("model config must be a non-empty JSON list")
    for i, entry in enumerate(entries):
        if not isinstance(entry, dict):
            raise ValueError(
                f"model config entry {i} must be an object, got "
                f"{type(entry).__name__}")
        missing = {"name", "base_path"} - set(entry)
        if missing:
            raise ValueError(
                f"model config entry {i} missing {sorted(missing)}")
        unknown = set(entry) - {"name", "base_path", "max_batch",
                                "version_policy",
                                "continuous_batching"}
        if unknown:
            raise ValueError(
                f"model config entry {i} has unknown keys "
                f"{sorted(unknown)}")
    names = [e["name"] for e in entries]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate model names in config: {names}")
    return entries


def _join_gang(device):
    """The gang's control line, once this process has joined the gang
    its env describes; None for one process."""
    from kubeflow_tpu_torch.training.launcher import initialize_distributed

    if not initialize_distributed(device=device.type):
        return None
    from kubeflow_tpu_torch.inference.engine.gang import GangLink

    gang = GangLink()
    logger.info("gang of %d ranks: this process is %s", gang.size,
                "the server" if gang.leader else "a follower")
    return gang


def _follow(gang, device) -> int:
    """A follower rank's whole life: rank 0's loads and their work,
    until rank 0's manager stops."""
    import torch.distributed as dist

    summary = ModelManager(device=device, gang=gang).follow()
    logger.info("gang follower %d: rank 0 stopped; loaded %s, closed %s",
                dist.get_rank(), summary["loaded"], summary["closed"])
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kft-model-server")
    # --port is the gRPC port, exactly like tensorflow_model_server
    # (tf-serving.libsonnet:107 pins --port=9000 for gRPC); REST rides
    # --rest_port, mirroring TF-Serving's --rest_api_port split.
    parser.add_argument("--port", type=int, default=9000)
    parser.add_argument("--rest_port", type=int, default=8500)
    parser.add_argument("--model_name")
    parser.add_argument("--model_base_path")
    parser.add_argument("--model_config_file",
                        help="JSON list of {name, base_path[, max_batch]}"
                             " — multi-model serving (TF-Serving's "
                             "--model_config_file role)")
    parser.add_argument("--max_batch", type=int, default=64)
    parser.add_argument("--continuous_batching", action="store_true",
                        help="serve generate-method models through "
                             "the slot-based decode engine "
                             "(inference/engine/): requests join and "
                             "retire mid-decode, and ?stream/SSE + "
                             "gRPC GenerateStream token streaming "
                             "become available")
    parser.add_argument("--role", default="any",
                        choices=_roles()[0],
                        help="replica role for prefill/decode pool "
                             "splitting: prefill replicas serve the "
                             "compute-bound prompt pass and hand the "
                             "KV cache off; decode replicas adopt it "
                             "and stream tokens; any does both")
    parser.add_argument("--version_policy", default="latest",
                        help="latest | all | specific:<v>[,<v>...] — "
                             "which version dirs to serve (TF-Serving "
                             "ServableVersionPolicy role; rollback = "
                             "specific:<old>)")
    parser.add_argument("--poll_interval", type=float, default=5.0)
    parser.add_argument("--fault_plan", default=None,
                        help="JSON fault-injection plan file (hot-"
                             "reloaded; REFUSED unless "
                             "KFT_ENABLE_FAULTS=1 — chaos tests and "
                             "bench only, never production)")
    parser.add_argument("--tenant_policy", default=None,
                        help="JSON tenant quota/weight policy file "
                             "(hot-reloaded, last-good-on-malformed; "
                             "enables per-tenant token-bucket quotas "
                             "— over-quota = 429 — and weighted-fair "
                             "queueing across tenants)")
    parser.add_argument("--sse_keepalive", type=float,
                        default=SSE_KEEPALIVE_INTERVAL_S,
                        help="seconds between ': keepalive' SSE "
                             "comment frames during inter-token "
                             "gaps on streamed generates")
    parser.add_argument("--trace_tail_keep", type=float, default=None,
                        help="enable tail-based span sampling: keep "
                             "this fraction of happy-path spans "
                             "(errors/deadline outcomes and the "
                             "slowest decile are always retained — "
                             "the /tracez?trace_id= exemplar "
                             "workflow)")
    parser.add_argument("--device", default=None,
                        help="where models load: cuda (the default; "
                             "the server refuses to start without a "
                             "GPU) or cpu, only when asked: by this "
                             "flag or by JAX_PLATFORMS=cpu in the env")
    args = parser.parse_args(argv)
    single = bool(args.model_name or args.model_base_path)
    if bool(args.model_config_file) == single:
        parser.error("exactly one of --model_name/--model_base_path "
                     "or --model_config_file is required")
    if single and not (args.model_name and args.model_base_path):
        parser.error("--model_name and --model_base_path go together")
    from kubeflow_tpu_torch.serving.manager import parse_version_policy

    try:
        parse_version_policy(args.version_policy)
    except ValueError as e:
        parser.error(str(e))
    logging.basicConfig(
        level=logging.INFO,
        format="%(levelname)s|%(asctime)s|%(pathname)s|%(lineno)d| %(message)s",
        datefmt="%Y-%m-%dT%H:%M:%S",
    )
    from kubeflow_tpu_torch.utils.device import resolve_device
    from kubeflow_tpu_torch.utils.platform import default_device

    # Before any port opens: a GPU server on a machine without CUDA
    # fails here, never serves from the CPU unasked.
    device = resolve_device(default_device(args.device))
    if args.trace_tail_keep is not None:
        from kubeflow_tpu_torch.obs.tracing import TRACER

        TRACER.set_tail_sampling(args.trace_tail_keep)
    registry = None
    if args.tenant_policy:
        from kubeflow_tpu_torch.serving.tenancy import (
            TenantPolicy,
            TenantPolicySource,
            TenantRegistry,
        )

        # Parse once at startup so a broken INITIAL policy fails the
        # process loudly (the hot-reload path keeps last-good only
        # for REwrites of a policy that once parsed).
        try:
            with open(args.tenant_policy) as f:
                initial = TenantPolicy.from_json(f.read())
        except (OSError, ValueError) as e:
            parser.error(f"--tenant_policy {args.tenant_policy}: {e}")
        registry = TenantRegistry(TenantPolicySource(
            args.tenant_policy, initial=initial))
    gang = _join_gang(device)
    if gang is not None and not gang.leader:
        return _follow(gang, device)
    manager = ModelManager(poll_interval_s=args.poll_interval,
                           tenancy_registry=registry, device=device,
                           gang=gang)
    # Defer the (slow) first model loads to the poll thread: the ports
    # open immediately and /healthz answers 503 until loaded, so
    # kubelet probes see a live-but-not-ready pod instead of a dead one.
    if args.model_config_file:
        models = load_model_config(args.model_config_file)
    else:
        models = [{"name": args.model_name,
                   "base_path": args.model_base_path,
                   "max_batch": args.max_batch}]
    for entry in models:
        manager.add_model(entry["name"], entry["base_path"],
                          max_batch=int(entry.get("max_batch",
                                                  args.max_batch)),
                          version_policy=entry.get("version_policy",
                                                   args.version_policy),
                          continuous_batching=bool(entry.get(
                              "continuous_batching",
                              args.continuous_batching)),
                          initial_poll=False)
    from kubeflow_tpu_torch.serving.grpc_server import make_server

    grpc_srv, _ = make_server(manager, args.port)
    grpc_srv.start()
    app = make_app(manager, role=args.role,
                   fault_plan=args.fault_plan,
                   sse_keepalive_s=args.sse_keepalive)
    app.listen(args.rest_port)
    logger.info("model server: gRPC on :%d, REST on :%d (models=%s, "
                "role=%s)", args.port, args.rest_port,
                [m["name"] for m in models], args.role)
    manager.start()

    # k8s sends SIGTERM then waits terminationGracePeriodSeconds:
    # stop taking new RPCs, let in-flight batches drain, then exit so
    # rolling updates never cut requests mid-predict. The drain runs
    # in ITS OWN THREAD: blocking on the IOLoop would freeze health
    # probes and the executor-resume callbacks that in-flight REST
    # handlers need to finish their responses.
    import signal
    import threading

    loop = tornado.ioloop.IOLoop.current()
    draining = threading.Event()

    def _drain_and_stop():
        grpc_srv.stop(grace=10).wait(timeout=15)
        manager.stop()
        loop.add_callback(loop.stop)

    def _graceful_exit(signum, frame):
        del frame
        if draining.is_set():
            return  # second signal while already draining
        draining.set()
        logger.info("signal %d: draining and shutting down", signum)
        threading.Thread(target=_drain_and_stop, daemon=True,
                         name="graceful-drain").start()

    signal.signal(signal.SIGTERM, _graceful_exit)
    signal.signal(signal.SIGINT, _graceful_exit)
    loop.start()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
