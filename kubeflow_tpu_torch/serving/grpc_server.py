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

"""Native gRPC PredictionService listener — the :9000 contract.

The reference served raw gRPC on :9000 (``kubeflow/tf-serving/
tf-serving.libsonnet:106-111``) and its clients spoke it directly
(``components/k8s-model-server/inception-client/label.py:40-56``); the
reference proxy was built on GetModelMetadata (``components/
k8s-model-server/http-proxy/server.py:121-160``) and Classify
(``server.py:239-262``). This module is that surface: Predict,
Classify and GetModelMetadata on a real grpcio server.

No generated stubs: the methods are registered as *generic* raw-bytes
handlers (serializer/deserializer omitted, so grpcio hands the
request frame through untouched) and the hand-rolled codec in
serving/wire.py does the (de)serialization. That keeps the tree free
of a protoc step while serving the exact public wire format.

Execution goes through the same ``ServedModel.submit`` micro-batching
path as the REST surface, so gRPC and REST requests share batch
buckets on the card.

The port's copy of the reference's ``serving/grpc_server.py``; ``grpc``
is imported where a status is mapped or the server is built, so the
module imports without it.
"""

from __future__ import annotations

import concurrent.futures
import logging
import time
from typing import List, Optional, Tuple

import numpy as np

from kubeflow_tpu_torch.obs import tracing as obs_tracing
from kubeflow_tpu_torch.serving import wire
from kubeflow_tpu_torch.serving.tenancy import tenant_from_metadata, tenant_label
from kubeflow_tpu_torch.serving.manager import ModelManager
from kubeflow_tpu_torch.serving.overload import (
    DeadlineExceededError,
    OverloadedError,
    clamp_wait_s,
)

logger = logging.getLogger(__name__)

SERVICE_NAME = "tensorflow.serving.PredictionService"


def _abort_for(context, exc) -> None:
    """Map Python-side failures onto canonical gRPC status codes
    (mirrors the gRPC-Web handler's mapping, serving/server.py).
    Overload subclasses go BEFORE the RuntimeError catch-all:
    DEADLINE_EXCEEDED tells the client its budget is gone (do not
    retry), RESOURCE_EXHAUSTED says shed (retry with backoff)."""
    import grpc

    if isinstance(exc, KeyError):
        context.abort(grpc.StatusCode.NOT_FOUND, str(exc.args[0]))
    if isinstance(exc, ValueError):
        context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
    if isinstance(exc, (concurrent.futures.TimeoutError,
                        DeadlineExceededError)):
        context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                      str(exc) or "predict timed out")
    if isinstance(exc, OverloadedError):
        # QuotaExceededError (a subclass) lands here too: gRPC has no
        # 429, so both shed flavors map to RESOURCE_EXHAUSTED and the
        # message names the over-quota tenant (the REST surface keeps
        # the distinct 429 + QUOTA_EXCEEDED code).
        context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(exc))
    if isinstance(exc, RuntimeError):
        context.abort(grpc.StatusCode.UNAVAILABLE, str(exc))
    logger.exception("unhandled error in gRPC handler")
    context.abort(grpc.StatusCode.INTERNAL, type(exc).__name__)


def _record_grpc_span(obs_ctx, t0: float, *, model: str = "",
                      tenant: str = "", outcome: str = "ok") -> None:
    """The native listener's per-hop ROOT span — the :9000 half of
    the fleet waterfall (the REST surface's http_request twin): own
    span id for children to parent on, the proxy's span as parent,
    model + capped tenant labels. Context-less calls (no traceparent
    from the client) record nothing — there is no trace to join."""
    if obs_ctx is None or not obs_tracing.TRACER.enabled:
        return
    args = obs_tracing.root_span_args(obs_ctx, outcome=outcome)
    if model:
        args["model"] = model
    if tenant:
        args["tenant"] = tenant_label(tenant)
    obs_tracing.TRACER.record("grpc_request", "serving", t0,
                              time.monotonic() - t0, args)


def _context_deadline(context) -> Optional[float]:
    """Absolute monotonic deadline from the client's grpc-timeout
    metadata (grpcio surfaces it as time_remaining(); None when the
    client set no deadline)."""
    remaining = context.time_remaining()
    if remaining is None:
        return None
    return time.monotonic() + remaining


def start_predict(manager: ModelManager, request_bytes: bytes,
                  deadline: Optional[float] = None,
                  obs_ctx: Optional[obs_tracing.TraceContext] = None,
                  tenant: str = ""):
    """Shared Predict front half for both transports (native gRPC here,
    gRPC-Web in serving/server.py): decode → validate against the
    signature → submit to the micro-batcher. ``deadline`` (absolute
    monotonic) rides into the queue entry for admission control and
    eviction; ``obs_ctx`` (from gRPC metadata / HTTP headers) tags the
    manager's per-request spans. Returns (spec, loaded, future,
    output_filter); the caller awaits the future in its own
    concurrency style."""
    spec, inputs, output_filter = wire.decode_predict_request(
        request_bytes)
    model = manager.get_model(spec["name"])
    loaded = model.get(spec["version"])
    sig = loaded.signature(spec["signature_name"] or None)
    unknown = set(inputs) - set(sig.inputs)
    if unknown:
        raise ValueError(
            f"unknown inputs {sorted(unknown)}; signature has "
            f"{sorted(sig.inputs)}")
    input_name = next(iter(sig.inputs))
    if input_name not in inputs:
        raise ValueError(
            f"request missing input {input_name!r}; "
            f"got {sorted(inputs)}")
    # sig.method → the signature's own method runs (TF-Serving
    # semantics: Predict executes the named signature, whatever it
    # computes — so generate-method exports serve over gRPC too).
    # Submitting the resolved method (not None) keeps the batcher's
    # (signature, method, version) grouping aligned with REST
    # requests, so both transports share batch buckets.
    future = model.submit({input_name: inputs[input_name]},
                          spec["signature_name"] or None,
                          sig.method, spec["version"],
                          deadline=deadline, obs_ctx=obs_ctx,
                          tenant=tenant)
    return spec, loaded, future, output_filter


def finish_predict(spec, loaded, outputs, output_filter) -> bytes:
    """Shared Predict back half: apply output_filter, encode."""
    if output_filter:
        missing = set(output_filter) - set(outputs)
        if missing:
            raise ValueError(
                f"output_filter names unknown outputs "
                f"{sorted(missing)}; available {sorted(outputs)}")
        outputs = {k: outputs[k] for k in output_filter}
    return wire.encode_predict_response(
        outputs, spec["name"], loaded.version)


def start_classify(manager: ModelManager, request_bytes: bytes,
                   deadline: Optional[float] = None,
                   obs_ctx: Optional[obs_tracing.TraceContext] = None,
                   tenant: str = ""):
    """Shared Classify front half: decode tf.Examples → dense batch →
    submit. Returns (spec, loaded, future)."""
    spec, examples = wire.decode_classification_request(request_bytes)
    if not examples:
        raise ValueError("ClassificationRequest carries no examples")
    model = manager.get_model(spec["name"])
    loaded = model.get(spec["version"])
    sig = loaded.signature(spec["signature_name"] or None)
    input_name, input_spec = next(iter(sig.inputs.items()))
    batch = _examples_to_batch(examples, input_name,
                               tuple(input_spec.shape[1:]))
    future = model.submit({input_name: batch},
                          spec["signature_name"] or None,
                          "classify", spec["version"],
                          deadline=deadline, obs_ctx=obs_ctx,
                          tenant=tenant)
    return spec, loaded, future


def finish_classify(spec, loaded, outputs) -> bytes:
    classifications = _to_classifications(
        outputs, loaded.metadata.classes)
    return wire.encode_classification_response(
        classifications, spec["name"], loaded.version)


def get_model_metadata(manager: ModelManager,
                       request_bytes: bytes) -> bytes:
    """Shared GetModelMetadata body (no batcher round trip)."""
    spec, fields = wire.decode_get_model_metadata_request(request_bytes)
    unsupported = [f for f in fields if f != "signature_def"]
    if unsupported:
        raise ValueError(
            f"unsupported metadata_field {unsupported}; "
            f"only 'signature_def' is served")
    model = manager.get_model(spec["name"])
    loaded = model.get(spec["version"])
    signatures = {
        name: {
            "method": sig.method,
            "inputs": {k: (v.dtype, v.shape)
                       for k, v in sig.inputs.items()},
            "outputs": {k: (v.dtype, v.shape)
                        for k, v in sig.outputs.items()},
        }
        for name, sig in loaded.metadata.signatures.items()
    }
    return wire.encode_get_model_metadata_response(
        spec["name"], loaded.version, signatures)


class PredictionService:
    """Raw-bytes method behaviors for the generic handler."""

    def __init__(self, manager: ModelManager, *, timeout_s: float = 30.0):
        self._manager = manager
        self._timeout_s = timeout_s

    # -- Predict -----------------------------------------------------------

    def Predict(self, request: bytes, context) -> bytes:
        t0 = time.monotonic()
        obs_ctx, model, tenant = None, "", ""
        try:
            deadline = _context_deadline(context)
            # The trace context rides gRPC invocation metadata
            # (x-request-id / traceparent) — the proxy's binary hop
            # and any instrumented native client send it.
            obs_ctx = obs_tracing.from_grpc_metadata(
                context.invocation_metadata())
            # Tenant identity rides invocation metadata, the gRPC
            # half of the X-KFT-Tenant header contract.
            tenant = tenant_from_metadata(
                context.invocation_metadata(),
                getattr(self._manager, "tenancy", None))
            spec, loaded, future, output_filter = start_predict(
                self._manager, request, deadline=deadline,
                obs_ctx=obs_ctx, tenant=tenant)
            model = spec["name"]
            outputs = future.result(self._wait_s(deadline))
            body = finish_predict(spec, loaded, outputs, output_filter)
            _record_grpc_span(obs_ctx, t0, model=model, tenant=tenant)
            return body
        except Exception as e:  # noqa: BLE001 — mapped to grpc status
            _record_grpc_span(obs_ctx, t0, model=model, tenant=tenant,
                              outcome="error")
            _abort_for(context, e)

    # -- Classify ----------------------------------------------------------

    def Classify(self, request: bytes, context) -> bytes:
        try:
            deadline = _context_deadline(context)
            obs_ctx = obs_tracing.from_grpc_metadata(
                context.invocation_metadata())
            tenant = tenant_from_metadata(
                context.invocation_metadata(),
                getattr(self._manager, "tenancy", None))
            spec, loaded, future = start_classify(self._manager, request,
                                                  deadline=deadline,
                                                  obs_ctx=obs_ctx,
                                                  tenant=tenant)
            outputs = future.result(self._wait_s(deadline))
            return finish_classify(spec, loaded, outputs)
        except Exception as e:  # noqa: BLE001
            _abort_for(context, e)

    def _wait_s(self, deadline: Optional[float]) -> float:
        """Future-wait budget: the client's remaining deadline when it
        set one (never wait past it), else the server default."""
        return clamp_wait_s(deadline, self._timeout_s)

    # -- GenerateStream (server streaming) ---------------------------------

    def GenerateStream(self, request: bytes, context):
        """Server-streaming generate over the continuous-batching
        engine: the request is an ordinary PredictRequest against a
        generate signature; each streamed message is a
        PredictResponse carrying ONE sampled token (outputs ``row`` /
        ``index`` / ``token``), and the terminal message carries the
        full ``tokens`` [rows, T] array — so unary clients' decode of
        the final frame equals the unary Predict response. Runs on the
        gRPC worker thread (grpc's thread-per-RPC model: blocking
        bounded waits are the natural style here)."""
        t0 = time.monotonic()
        obs_ctx, tenant = None, ""
        try:
            deadline = _context_deadline(context)
            obs_ctx = obs_tracing.from_grpc_metadata(
                context.invocation_metadata())
            tenant = tenant_from_metadata(
                context.invocation_metadata(),
                getattr(self._manager, "tenancy", None))
            spec, inputs, _ = wire.decode_predict_request(request)
            model = self._manager.get_model(spec["name"])
            sig_name = spec["signature_name"] or None
            _, streams = model.submit_stream(
                inputs, sig_name, spec["version"], deadline=deadline,
                obs_ctx=obs_ctx, tenant=tenant)
        except Exception as e:  # noqa: BLE001 — mapped to grpc status
            _record_grpc_span(obs_ctx, t0, tenant=tenant,
                              outcome="error")
            _abort_for(context, e)
            return
        try:
            yield from self._drain_streams(spec, streams, deadline,
                                           context)
            _record_grpc_span(obs_ctx, t0, model=spec["name"],
                              tenant=tenant)
        except Exception as e:  # noqa: BLE001
            for s in streams:
                s.cancel()
            _record_grpc_span(obs_ctx, t0, model=spec["name"],
                              tenant=tenant, outcome="error")
            _abort_for(context, e)

    def _drain_streams(self, spec, streams, deadline, context):
        import threading

        signal = threading.Event()
        for s in streams:
            s.set_notify(signal.set)
        finished = [False] * len(streams)
        results: List[Optional[np.ndarray]] = [None] * len(streams)
        first_error: Optional[BaseException] = None
        while not all(finished):
            if not context.is_active():
                for s in streams:  # client hung up mid-stream
                    s.cancel()
                return
            signal.clear()
            progressed = False
            for r, s in enumerate(streams):
                for ev in s.drain():
                    progressed = True
                    if ev.final:
                        finished[r] = True
                        if ev.error is not None:
                            first_error = first_error or ev.error
                        else:
                            results[r] = s.result(timeout=1.0)
                    else:
                        yield wire.encode_predict_response(
                            {"row": np.asarray([r], np.int32),
                             "index": np.asarray([ev.index], np.int32),
                             "token": np.asarray([ev.token],
                                                 np.int32)},
                            spec["name"])
            if all(finished):
                break
            if not progressed and not signal.wait(
                    clamp_wait_s(deadline, self._timeout_s)):
                raise concurrent.futures.TimeoutError(
                    "stream timed out awaiting the engine")
        if first_error is not None:
            raise first_error
        yield wire.encode_predict_response(
            {"tokens": np.stack(results)}, spec["name"])

    # -- GetModelMetadata --------------------------------------------------

    def GetModelMetadata(self, request: bytes, context) -> bytes:
        try:
            return get_model_metadata(self._manager, request)
        except Exception as e:  # noqa: BLE001
            _abort_for(context, e)


def _examples_to_batch(examples: List[dict], input_name: str,
                       row_shape: Tuple[int, ...]) -> np.ndarray:
    """tf.Example feature dicts → one dense batch for the signature's
    single input. Dense float/int features are reshaped to the
    signature row shape; bytes features are rejected (the models take
    dense arrays — the REST surface's b64 path covers raw payloads)."""
    rows = []
    row_size = int(np.prod(row_shape)) if row_shape else 1
    for i, example in enumerate(examples):
        if input_name in example:
            value = example[input_name]
        elif len(example) == 1:
            value = next(iter(example.values()))
        else:
            raise ValueError(
                f"example {i} missing feature {input_name!r}; "
                f"got {sorted(example)}")
        if isinstance(value, list):  # bytes_list
            raise ValueError(
                f"example {i}: bytes features are not supported; send "
                f"dense float_list/int64_list of size {row_size}")
        arr = np.asarray(value)
        if arr.size != row_size:
            raise ValueError(
                f"example {i}: feature {input_name!r} has {arr.size} "
                f"values, signature row needs {row_size}")
        rows.append(arr.reshape(row_shape))
    return np.stack(rows)


def _to_classifications(outputs: dict,
                        classes: Optional[List[str]]
                        ) -> List[List[Tuple[str, float]]]:
    """{classes: (n,k) int, scores: (n,k) float} → per-example
    (label, score) pairs, using the export-time label vocabulary when
    the model ships one."""
    if "classes" not in outputs or "scores" not in outputs:
        raise ValueError(
            f"signature outputs {sorted(outputs)} do not carry "
            "classes/scores; use Predict for this model")
    idx = np.asarray(outputs["classes"])
    scores = np.asarray(outputs["scores"])
    result = []
    for row_idx, row_scores in zip(idx, scores):
        row = []
        for c, s in zip(row_idx, row_scores):
            label = (classes[int(c)]
                     if classes and 0 <= int(c) < len(classes)
                     else str(int(c)))
            row.append((label, float(s)))
        result.append(row)
    return result


def make_server(manager: ModelManager, port: int, *,
                max_workers: int = 16, timeout_s: float = 30.0):
    """Build + bind (not start) the gRPC server. Returns (server,
    bound_port); bound_port is the OS-assigned port when port=0."""
    import grpc

    service = PredictionService(manager, timeout_s=timeout_s)
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(behavior)
        for name, behavior in (("Predict", service.Predict),
                               ("Classify", service.Classify),
                               ("GetModelMetadata",
                                service.GetModelMetadata))
    }
    # Server-streaming generate (continuous batching): same
    # generic raw-bytes style, streaming arity.
    handlers["GenerateStream"] = grpc.unary_stream_rpc_method_handler(
        service.GenerateStream)
    server = grpc.server(
        concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers,
            thread_name_prefix="grpc-prediction"))
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),))
    bound = server.add_insecure_port(f"[::]:{port}")
    if bound == 0:
        raise RuntimeError(f"could not bind gRPC port {port}")
    return server, bound
