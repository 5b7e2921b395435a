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

"""Serving benchmarks: latency and throughput of the port's serving plane.

The port of ``kubeflow_tpu/serving/benchmark.py``: the same legs, the
same configs and result keys, driving the port's ``ModelManager``,
``ServedModel``, gRPC and REST servers and ``DecodeEngine``:

- ``run_serving_benchmark``: p50/p99 and requests/s over a real socket.
  Transport ``grpc`` is the native ``PredictionService`` with binary
  TensorProto payloads; ``http`` the REST/JSON surface and ``both`` the
  two on one loaded model. The REST server is tornado's: ``http`` and
  ``both`` import it when they start, and raise ``ImportError`` where it
  is missing (they never fall back to gRPC). A sweep mode reads the
  micro-batcher's fill at rising client counts.
- ``run_mixed_load_benchmark``: classify p50/p99 alone and under a
  continuous generate stream on one server.
- ``run_overload_benchmark``: an open-loop offered-load sweep past
  capacity, deadline-aware shedding on and off.
- ``run_continuous_benchmark``: the static coalescer against the
  continuous-batching engine at one offered load, with the engine's
  bitwise checks.
- ``run_prefix_benchmark``, ``run_tiered_prefix_benchmark`` and
  ``run_speculative_benchmark``: the engine's prefix cache, host tier
  and speculative decoding, each against its baseline, with the
  bitwise verdicts (warm == cold == B = 1 ``generate``, spec ==
  vanilla, greedy and sampled). The reference runs them at
  ``llama-test``; here each config takes ``model`` (default
  ``llama-test``), so the card can run them at llama3-8b. Their B = 1
  references run at the reference's cache length, which the engine's
  slots round up to whole pages: the verdicts hold only where a
  request's bits do not depend on that padding.
- ``run_tenant_benchmark``: the noisy-neighbour isolation sweep over a
  sleep-priced stub model.

Every leg takes ``device`` (``None`` → cuda; ``"cpu"`` on request).
Wall-clock fields are measurements of this run's machine; the bitwise
verdicts, completion counts and hit rates do not depend on the clock.
The obs-overhead and SLO legs need the collector and the SLO evaluator,
which the port does not have yet (ROADMAP A16)::

    python -m kubeflow_tpu_torch.serving.benchmark --transport grpc
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import tempfile
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubeflow_tpu_torch.utils.device import DeviceLike


@dataclasses.dataclass
class ServingBenchConfig:
    model: str = "inception-v3"  # registry name
    image_hw: int = 299
    clients: int = 4
    requests_per_client: int = 32
    warmup_requests: int = 8
    # Buckets 1..max_batch all warm at load; keep small so the bench
    # doesn't spend minutes warming buckets it never fills.
    max_batch: int = 4
    port: int = 0  # 0 = ephemeral (repeat runs can't collide)
    transport: str = "http"  # http | grpc | both
    # Non-empty → concurrency sweep: for each N run the drive with N
    # clients and report rps + mean batch fill (uses `transport`, or
    # grpc when transport="both": the cheaper wire isolates batching).
    sweep_clients: Sequence[int] = ()
    # Language models are exported with a generate signature and driven
    # through ``:generate`` / gRPC Predict instead of ``:classify``:
    prompt_len: int = 32
    new_tokens: int = 16
    # Decode slicing: export generate with K-token slices (None =
    # monolithic decode).
    decode_chunk: Optional[int] = None
    # f32 keeps toy-model comparisons exact; bf16 is the real serving
    # dtype.
    model_dtype: str = "float32"


def _is_language(model: str) -> bool:
    from kubeflow_tpu_torch.models.registry import get_model

    return get_model(model).family == "language"


def _encoder_rejection(model: str) -> Optional[str]:
    """The error for an encoder-only language model, which the
    :generate wire can't drive, else None (one message for the CLI and
    run_serving_benchmark)."""
    from kubeflow_tpu_torch.models.registry import get_model

    entry = get_model(model)
    if entry.family == "language" and not entry.decoder:
        return (
            f"model {model!r} is an encoder-only language model with "
            f"no generate path; the serving benchmark drives language "
            f"models through :generate (use a causal decoder like "
            f"llama-test, or benchmark encoders via classify models)")
    return None


def _export(config: ServingBenchConfig, device: DeviceLike = None) -> str:
    """A version dir for ``config.model`` with random weights (seed 0)
    in ``config.model_dtype``, drawn on ``device``: a generate export for
    a language model (through ``kft-export``'s own ``_build_metadata``, so
    the benchmark measures the artifact ``kft-export --generate``
    writes), a classify export for a vision model (its ``batch_stats``
    fp32)."""
    import torch

    from kubeflow_tpu_torch.models.convert import (
        init_params,
        init_vision,
        unflatten_tree,
    )
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.serving.export import export_model
    from kubeflow_tpu_torch.serving.export_cli import (
        _build_metadata,
        export_tree,
    )
    from kubeflow_tpu_torch.serving.signature import (
        ModelMetadata,
        Signature,
        TensorSpec,
    )
    from kubeflow_tpu_torch.utils.device import torch_dtype

    dtype = torch_dtype(config.model_dtype)
    entry = get_model(config.model)
    if _is_language(config.model):

        generate_config = {"max_new_tokens": config.new_tokens,
                           "temperature": 0.0}
        if config.decode_chunk:
            generate_config["decode_chunk_tokens"] = config.decode_chunk
        meta = _build_metadata(
            "bench", config.model, entry, config.prompt_len, "generate",
            generate_config, {"dtype": config.model_dtype})
        module = entry.make(dtype=config.model_dtype)
        # Every floating weight in the serving dtype, the head too (the
        # reference's cast_floating of its init).
        params = init_params(module, seed=0, device=device, dtype=dtype)
        variables = {"params": export_tree(module, params)}
    else:
        hw = config.image_hw
        meta = ModelMetadata(
            model_name="bench", registry_name=config.model,
            model_kwargs={"dtype": config.model_dtype},
            signatures={"serving_default": Signature(
                method="classify",
                inputs={"images": TensorSpec("float32", (-1, hw, hw, 3))},
                outputs={"classes": TensorSpec("int32", (-1, 5)),
                         "scores": TensorSpec("float32", (-1, 5))})})
        module = entry.make(dtype=config.model_dtype)
        params, stats = init_vision(module, seed=0, device=device)
        # The weights in the serving dtype; BN's running statistics stay
        # fp32, the standard mixed layout.
        params = {k: v.to(dtype) for k, v in params.items()}
        variables = {
            "params": export_tree(module, params),
            "batch_stats": unflatten_tree({
                k.replace(".", "/"): v.cpu().numpy()
                for k, v in stats.items()})}
    del params
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    base = pathlib.Path(tempfile.mkdtemp()) / "bench"
    export_model(str(base), 1, meta, variables)
    return str(base)


class _ServerHandle:
    def __init__(self):
        self.port: int = 0
        self.started = threading.Event()
        self.loop = None


def _serve(manager, port: int, handle: _ServerHandle):
    import asyncio

    import tornado.ioloop

    from kubeflow_tpu_torch.serving.server import make_app

    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    app = make_app(manager)
    server = app.listen(port)
    handle.port = next(iter(server._sockets.values())).getsockname()[1]
    handle.loop = tornado.ioloop.IOLoop.current()
    handle.started.set()
    handle.loop.start()


def _http_request_fn(port: int, payload: bytes,
                     verb: str = "classify") -> Callable[[], float]:
    """One JSON round trip (urllib, a fresh connection per request, as
    the reference client does)."""
    url = f"http://127.0.0.1:{port}/v1/models/bench:{verb}"

    def one_request(timeout: float = 120.0) -> float:
        req = urllib.request.Request(
            url, data=payload, headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = json.load(resp)
        dt = time.perf_counter() - t0
        assert "predictions" in body, body
        return dt

    return one_request


def _grpc_request_fn(channel, request: bytes,
                     expect_key: str = "scores") -> Callable[[], float]:
    """One binary Predict round trip on a persistent channel. Predict
    runs the signature's own method, so the same RPC serves classify
    and generate exports."""
    from kubeflow_tpu_torch.serving import wire

    call = channel.unary_unary("/tensorflow.serving.PredictionService/Predict")

    def one_request(timeout: float = 120.0) -> float:
        t0 = time.perf_counter()
        response = call(request, timeout=timeout)
        dt = time.perf_counter() - t0
        _, outputs = wire.decode_predict_response(response)
        assert expect_key in outputs, sorted(outputs)
        return dt

    return one_request


def _remove_export(base: str) -> None:
    import shutil

    shutil.rmtree(pathlib.Path(base).parent, ignore_errors=True)


def run_serving_benchmark(config: ServingBenchConfig,
                          device: DeviceLike = None) -> Dict[str, float]:
    from kubeflow_tpu_torch.serving.manager import ModelManager

    if config.transport not in ("http", "grpc", "both"):
        raise ValueError(f"unknown transport {config.transport!r}")
    rejection = _encoder_rejection(config.model)
    if rejection:
        raise ValueError(rejection)
    want_http = config.transport in ("http", "both")
    want_grpc = config.transport in ("grpc", "both")
    if want_http:
        try:
            import tornado  # noqa: F401
        except ImportError as e:
            raise ImportError(
                f"transport {config.transport!r} needs the REST server, "
                f"which needs tornado: {e}; use transport='grpc'") from e
    manager = ModelManager(poll_interval_s=3600, device=device)
    base = _export(config, manager.device)
    model = manager.add_model("bench", base, max_batch=config.max_batch)
    handle, server_thread, grpc_server, grpc_port = None, None, None, 0
    try:
        # Fail here if the first load produced no version, not as
        # per-request "no loaded version" failures later.
        model.get()
        if want_http:
            handle = _ServerHandle()
            server_thread = threading.Thread(
                target=_serve, args=(manager, config.port, handle),
                daemon=True)
            server_thread.start()
            assert handle.started.wait(30), "server thread never started"
        if want_grpc:
            from kubeflow_tpu_torch.serving.grpc_server import make_server

            grpc_server, grpc_port = make_server(manager, 0)
            grpc_server.start()
        return _drive(config, manager, model, handle, grpc_port)
    finally:
        if grpc_server is not None:
            grpc_server.stop(grace=1)
        if handle is not None and handle.loop is not None:
            handle.loop.add_callback(handle.loop.stop)
            server_thread.join(10)
        manager.stop()
        _remove_export(base)


def _measure(request_fn: Callable[[], float], clients: int,
             requests_per_client: int) -> Dict[str, float]:
    """Run ``clients`` threads × ``requests_per_client`` requests through
    request_fn; latency percentiles and aggregate requests/s."""
    latencies: List[float] = []
    lat_lock = threading.Lock()
    errors: List[str] = []

    def client():
        try:
            mine = []
            for _ in range(requests_per_client):
                mine.append(request_fn())
            with lat_lock:
                latencies.extend(mine)
        except Exception as e:  # noqa: BLE001
            with lat_lock:
                errors.append(repr(e))

    start = time.perf_counter()
    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    stragglers = [t for t in threads if t.is_alive()]
    assert not stragglers, (
        f"{len(stragglers)} client thread(s) still running; refusing to "
        "report statistics over a partial latency list")
    elapsed = time.perf_counter() - start
    assert not errors, errors[:3]

    lat = np.asarray(latencies) * 1e3
    return {
        "requests": len(latencies),
        "p50_ms": round(float(np.percentile(lat, 50)), 2),
        "p90_ms": round(float(np.percentile(lat, 90)), 2),
        "p99_ms": round(float(np.percentile(lat, 99)), 2),
        "throughput_rps": round(len(latencies) / elapsed, 1),
    }


def _drive(config: ServingBenchConfig, manager, model,
           handle: Optional[_ServerHandle],
           grpc_port: int) -> Dict[str, float]:
    import contextlib

    rng = np.random.RandomState(42)
    if _is_language(config.model):
        inputs = {"input_ids": rng.randint(
            0, 128, (1, config.prompt_len)).astype(np.int32)}
        verb, expect_key = "generate", "tokens"
    else:
        hw = config.image_hw
        inputs = {"images": (rng.randint(0, 256, (1, hw, hw, 3))
                             / 255.0).astype(np.float32)}
        verb, expect_key = "classify", "scores"
    feed, = inputs.values()

    json_payload = json.dumps({"instances": feed.tolist()}).encode()
    sizes = {"json_request_bytes": len(json_payload)}
    transports: Dict[str, Callable[[], float]] = {}
    with contextlib.ExitStack() as stack:
        if config.transport in ("http", "both"):
            transports["http"] = _http_request_fn(handle.port, json_payload,
                                                  verb)
        if config.transport in ("grpc", "both"):
            import grpc

            from kubeflow_tpu_torch.serving import wire

            grpc_request = wire.encode_predict_request("bench", inputs)
            sizes["grpc_request_bytes"] = len(grpc_request)
            # Closed on exit even when a measurement assertion fires
            # mid-drive: the channel's threads must not outlive the run.
            channel = stack.enter_context(contextlib.closing(
                grpc.insecure_channel(f"127.0.0.1:{grpc_port}")))
            transports["grpc"] = _grpc_request_fn(channel, grpc_request,
                                                  expect_key)
        return _drive_measurements(config, model, transports, sizes,
                                   inputs)


def _drive_measurements(config: ServingBenchConfig, model, transports,
                        sizes, inputs) -> Dict[str, float]:
    # Warmup: warm every wire under test so neither pays first-touch
    # costs in the timed run.
    for fn in transports.values():
        for _ in range(config.warmup_requests):
            fn()

    result: Dict[str, float] = {
        "model": config.model,
        "model_dtype": config.model_dtype,
        "clients": config.clients,
        **sizes,
    }
    single = len(transports) == 1
    for name, fn in transports.items():
        stats = _measure(fn, config.clients, config.requests_per_client)
        for key, value in stats.items():
            result[key if single else f"{name}_{key}"] = value

    # Concurrency sweep: the batching win against client count.
    if config.sweep_clients:
        sweep_fn = transports.get("grpc", transports.get("http"))
        sweep_rows = []
        for n in config.sweep_clients:
            model.batch_stats(reset=True)
            stats = _measure(sweep_fn, n, config.requests_per_client)
            fill = model.batch_stats()
            sweep_rows.append({
                "clients": n,
                "throughput_rps": stats["throughput_rps"],
                "p50_ms": stats["p50_ms"],
                "p99_ms": stats["p99_ms"],
                "batches": fill["batches"],
                "mean_batch_fill": fill["mean_fill"],
            })
        result["sweep"] = sweep_rows

    # The bare model on the same single input: the wire's and the
    # batcher's cost over the model's.
    loaded = model.get()
    out_key = next(iter(loaded.metadata.signatures[
        "serving_default"].outputs))
    direct = []
    for _ in range(16):
        t0 = time.perf_counter()
        out = loaded.run(inputs)
        np.asarray(out[out_key])  # run() returns host arrays: the fence
        direct.append(time.perf_counter() - t0)
    result["direct_model_ms"] = round(float(np.median(direct)) * 1e3, 2)
    return result


@dataclasses.dataclass
class MixedLoadConfig:
    """Classify + generate on ONE server: each model has its own queue
    and batcher thread, but their executions share the device, so a long
    decode can head-of-line-block millisecond classify batches. This
    measures classify p50/p99 alone and while M generate clients stream
    continuously."""

    classify_model: str = "resnet-test"
    image_hw: int = 32
    generate_model: str = "llama-test"
    prompt_len: int = 32
    new_tokens: int = 64
    classify_clients: int = 4
    classify_requests: int = 40
    generate_clients: int = 2
    generate_requests: int = 8  # generate-alone phase, per client
    max_batch: int = 8
    model_dtype: str = "float32"
    decode_chunk: Optional[int] = None  # K-token decode slices


def run_mixed_load_benchmark(config: MixedLoadConfig,
                             device: DeviceLike = None) -> Dict[str, Any]:
    import contextlib

    import grpc

    from kubeflow_tpu_torch.serving import wire
    from kubeflow_tpu_torch.serving.grpc_server import make_server
    from kubeflow_tpu_torch.serving.manager import ModelManager

    manager = ModelManager(poll_interval_s=3600, device=device)
    cls_base = _export(ServingBenchConfig(
        model=config.classify_model, image_hw=config.image_hw,
        max_batch=config.max_batch, model_dtype=config.model_dtype),
        manager.device)
    gen_base = _export(ServingBenchConfig(
        model=config.generate_model, prompt_len=config.prompt_len,
        new_tokens=config.new_tokens, max_batch=config.max_batch,
        model_dtype=config.model_dtype,
        decode_chunk=config.decode_chunk), manager.device)
    server = None
    try:
        manager.add_model("cls", cls_base, max_batch=config.max_batch)
        manager.add_model("gen", gen_base, max_batch=config.max_batch)
        server, port = make_server(manager, 0)
        server.start()
        rng = np.random.RandomState(7)
        hw = config.image_hw
        cls_request = wire.encode_predict_request("cls", {
            "images": (rng.randint(0, 256, (1, hw, hw, 3)) / 255.0
                       ).astype(np.float32)})
        gen_request = wire.encode_predict_request("gen", {
            "input_ids": rng.randint(
                0, 128, (1, config.prompt_len)).astype(np.int32)})
        with contextlib.closing(grpc.insecure_channel(
                f"127.0.0.1:{port}")) as channel:
            cls_fn = _grpc_request_fn(channel, cls_request, "scores")
            gen_fn = _grpc_request_fn(channel, gen_request, "tokens")
            for _ in range(3):  # warm both paths
                cls_fn()
                gen_fn()

            gen_alone = _measure(gen_fn, config.generate_clients,
                                 config.generate_requests)
            cls_alone = _measure(cls_fn, config.classify_clients,
                                 config.classify_requests)

            # Mixed phase: M generate streamers run CONTINUOUSLY while
            # the classify fleet is measured. A streamer dying mid-phase
            # would silently measure an unloaded server: failures are
            # recorded and the phase refuses to report over a dead load.
            stop = threading.Event()
            gen_done = [0] * config.generate_clients
            gen_errors: List[str] = []

            def streamer(i: int) -> None:
                while not stop.is_set():
                    try:
                        gen_fn()
                    except Exception as e:  # noqa: BLE001
                        gen_errors.append(repr(e))
                        return
                    gen_done[i] += 1

            streamers = [threading.Thread(target=streamer, args=(i,),
                                          daemon=True)
                         for i in range(config.generate_clients)]
            t0 = time.perf_counter()
            for t in streamers:
                t.start()
            cls_mixed = _measure(cls_fn, config.classify_clients,
                                 config.classify_requests)
            stop.set()
            for t in streamers:
                t.join(120)
            gen_elapsed = time.perf_counter() - t0
            assert not gen_errors, (
                f"generate stream collapsed mid-measurement; the mixed "
                f"numbers would describe an idle device: {gen_errors[:2]}")

        return {
            "classify_model": config.classify_model,
            "generate_model": config.generate_model,
            "new_tokens": config.new_tokens,
            "decode_chunk": config.decode_chunk,
            "generate_clients": config.generate_clients,
            "classify_clients": config.classify_clients,
            "generate_alone": gen_alone,
            "classify_alone": cls_alone,
            "classify_under_generate": cls_mixed,
            "generate_rps_under_mix": round(sum(gen_done) / gen_elapsed,
                                            2),
            "classify_p99_degradation_x": round(
                cls_mixed["p99_ms"] / max(cls_alone["p99_ms"], 1e-9), 2),
            "classify_p50_degradation_x": round(
                cls_mixed["p50_ms"] / max(cls_alone["p50_ms"], 1e-9), 2),
        }
    finally:
        if server is not None:
            server.stop(grace=1)
        manager.stop()
        for base in (cls_base, gen_base):
            _remove_export(base)


@dataclasses.dataclass
class OverloadBenchConfig:
    """Offered-load sweep past capacity, deadline-aware shedding on and
    off: with shedding, goodput at 2× offered load should hold near
    capacity and the p99 of successful requests stay inside the
    deadline; without it the queue admits work whose deadline can only
    lapse, and goodput collapses.

    The drive calls ``ServedModel.submit`` directly: the queue, batcher,
    admission controller and the real model, without the HTTP hop."""

    model: str = "resnet-test"
    image_hw: int = 64
    max_batch: int = 2  # small on purpose: a capacity the sweep can
    # exceed with hundreds of requests, not tens of thousands.
    # queue_capacity stays at the production default.
    queue_capacity: int = 4096
    deadline_ms: float = 500.0
    phase_seconds: float = 4.0
    offered_x: Sequence[float] = (0.5, 1.0, 2.0)
    capacity_clients: int = 16
    capacity_requests: int = 20
    model_dtype: str = "float32"


def _overload_drive(model, inputs, rate_rps: float, duration_s: float,
                    deadline_ms: float, shedding: bool) -> Dict[str, Any]:
    """Fire submits at a fixed arrival rate (open loop: arrivals do not
    slow down when the server does; overload only exists in open-loop
    traffic). Every client abandons at the deadline either way; with
    shedding off the server never hears of it."""
    import concurrent.futures

    from kubeflow_tpu_torch.serving import overload

    results: List[Any] = []
    lock = threading.Lock()
    budget_s = deadline_ms / 1e3

    def one():
        t0 = time.perf_counter()
        deadline = overload.deadline_after(budget_s) if shedding else None
        try:
            future = model.submit(inputs, None, None, None,
                                  deadline=deadline)
            future.result(budget_s)
            outcome = "ok"
        except overload.OverloadedError:
            outcome = "shed"
        except overload.DeadlineExceededError:
            outcome = "expired"
        except concurrent.futures.TimeoutError:
            outcome = "client_timeout"  # abandoned; server unaware
        with lock:
            results.append((outcome, time.perf_counter() - t0))

    n = max(1, int(rate_rps * duration_s))
    interval = 1.0 / rate_rps
    # A pre-spawned worker pool on striped arrival schedules (worker i
    # takes arrivals i, i+P, ...): a thread per request would cost the
    # host the capacity being measured.
    pool = min(n, max(8, int(rate_rps * budget_s * 1.5) + 1))
    start = time.perf_counter()

    def worker(i: int):
        for k in range(i, n, pool):
            delay = start + k * interval - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            one()

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(pool)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(duration_s + budget_s + 30)
    counts: Dict[str, int] = {}
    for outcome, _ in results:
        counts[outcome] = counts.get(outcome, 0) + 1
    ok_lat = np.asarray([lat for outcome, lat in results
                         if outcome == "ok"]) * 1e3
    row: Dict[str, Any] = {
        "shedding": shedding,
        "offered_rps": round(rate_rps, 1),
        "sent": n,
        "ok": counts.get("ok", 0),
        "shed": counts.get("shed", 0),
        "expired": counts.get("expired", 0),
        "client_timeout": counts.get("client_timeout", 0),
        "goodput_rps": round(counts.get("ok", 0) / duration_s, 1),
    }
    if ok_lat.size:
        row["ok_p50_ms"] = round(float(np.percentile(ok_lat, 50)), 1)
        row["ok_p99_ms"] = round(float(np.percentile(ok_lat, 99)), 1)
    return row


def run_overload_benchmark(config: OverloadBenchConfig,
                           device: DeviceLike = None) -> Dict[str, Any]:
    from kubeflow_tpu_torch.serving.manager import ModelManager

    manager = ModelManager(poll_interval_s=3600, device=device)
    base = _export(ServingBenchConfig(
        model=config.model, image_hw=config.image_hw,
        max_batch=config.max_batch, model_dtype=config.model_dtype),
        manager.device)
    try:
        model = manager.add_model("bench", base,
                                  max_batch=config.max_batch,
                                  queue_capacity=config.queue_capacity)
        model.get()
        rng = np.random.RandomState(11)
        hw = config.image_hw
        inputs = {"images": (rng.randint(0, 256, (1, hw, hw, 3))
                             / 255.0).astype(np.float32)}

        def closed_loop_request(timeout: float = 120.0) -> float:
            t0 = time.perf_counter()
            model.submit(inputs, None, None, None).result(timeout)
            return time.perf_counter() - t0

        for _ in range(6):  # warm the buckets
            closed_loop_request()
        # Closed-loop capacity: the goodput ceiling the sweep is priced
        # against.
        capacity = _measure(closed_loop_request, config.capacity_clients,
                            config.capacity_requests)["throughput_rps"]
        phases = []
        # Both modes of one offered load run back to back, off first.
        for x in config.offered_x:
            for shedding in (False, True):
                model.batch_stats(reset=True)
                row = _overload_drive(model, inputs, x * capacity,
                                      config.phase_seconds,
                                      config.deadline_ms, shedding)
                row["offered_x"] = x
                # Drain before the snapshot, so one phase's backlog
                # doesn't land in the next.
                drain_by = time.monotonic() + 30
                while (model.queue_depth() > 0
                       and time.monotonic() < drain_by):
                    time.sleep(0.05)
                time.sleep(config.deadline_ms / 1e3)
                server = model.batch_stats()
                row["server"] = server
                # Every shed or expired request is one the model never
                # dispatched: rows == sent − shed − expired (a request
                # is one row).
                row["never_dispatched_ok"] = (
                    server["rows"] == row["sent"] - server["shed"]
                    - server["expired"])
                phases.append(row)

        def goodput(shedding: bool, x: float) -> float:
            return next(r["goodput_rps"] for r in phases
                        if r["shedding"] is shedding
                        and r["offered_x"] == x)

        worst_x = max(config.offered_x)
        # The goodput ceiling: the best rate shown anywhere in the run
        # (the closed-loop probe underestimates it).
        ceiling = max(capacity,
                      max(r["goodput_rps"] for r in phases))
        return {
            "model": config.model,
            "max_batch": config.max_batch,
            "queue_capacity": config.queue_capacity,
            "deadline_ms": config.deadline_ms,
            "capacity_rps": capacity,
            "goodput_ceiling_rps": ceiling,
            "phases": phases,
            "goodput_overload_on_vs_capacity": round(
                goodput(True, worst_x) / ceiling, 3),
            "goodput_overload_off_vs_capacity": round(
                goodput(False, worst_x) / ceiling, 3),
            "never_dispatched_ok": all(r["never_dispatched_ok"]
                                       for r in phases),
        }
    finally:
        manager.stop()
        _remove_export(base)


# -- the engine legs ---------------------------------------------------------


def _engine_model(name: str, model_dtype: str, cache_size: int,
                  device: DeviceLike):
    """``(model, params)``: ``name`` with a cache of ``cache_size``, the
    reference's own length (the engine's slots round it up to whole
    pages; the B = 1 references run on this model as it stands), and
    random params from seed 0 in the serving layout, on ``device``."""
    from kubeflow_tpu_torch.models.convert import init_params
    from kubeflow_tpu_torch.models.registry import get_model

    model = get_model(name).make(dtype=model_dtype, cache_size=cache_size)
    return model, init_params(model, seed=0, device=device)


def _b1(model, params, prompt, new_tokens: int, key,
        **sampling) -> np.ndarray:
    """One request alone through B = 1 ``generate``: its tokens."""
    import torch

    from kubeflow_tpu_torch.inference.generate import generate

    device = next(iter(params.values())).device
    prompt = np.asarray(prompt, np.int32)
    tokens, _ = generate(
        model, params, torch.from_numpy(prompt)[None].to(device),
        max_new_tokens=new_tokens, rng=np.asarray(key)[None, :],
        prompt_lengths=torch.tensor([len(prompt)], device=device),
        **sampling)
    return tokens[0].cpu().numpy()


@dataclasses.dataclass
class ContinuousBenchConfig:
    """Mixed-length open-loop sweep: the static coalescer against the
    continuous-batching engine at the same offered load. Requests
    alternate short (``short_tokens``) and long (``long_tokens``)
    budgets; the static stack has no per-request budget, so a short
    request rides the whole long decode, the head-of-line cost the
    slot engine removes by retiring rows early and admitting between
    slices. Both phases drive ``ServedModel`` directly, back to back on
    one arrival schedule."""

    prompt_len: int = 16
    short_tokens: int = 4
    long_tokens: int = 24
    num_requests: int = 36
    slots: int = 4  # engine slots AND the static max_batch
    page_size: int = 8
    slice_tokens: int = 4
    batch_window_s: float = 0.002  # the coalescer's default
    #: offered loads as multiples of the measured static capacity
    #: (full-batch decode throughput).
    rates_x: Sequence[float] = (0.75, 1.25)
    #: rows for the in-bench bitwise checks (greedy rides the serving
    #: engine mid-churn; sampled rides a dedicated engine).
    equality_rows: int = 3
    model_dtype: str = "float32"


def _continuous_phase(submit_one, n: int, rate_rps: float,
                      budgets: Sequence[int]) -> Dict[str, Any]:
    """Open-loop drive: request k is fired at ``k/rate`` however the
    server keeps up; latency is measured from the SCHEDULED arrival
    (queueing behind a slow server counts, as an open-loop client feels
    it)."""
    done = [None] * n
    lock = threading.Lock()
    start = time.perf_counter()
    interval = 1.0 / rate_rps

    def worker(i: int, stripe: int):
        for k in range(i, n, stripe):
            scheduled = start + k * interval
            delay = scheduled - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            latency, ttft = submit_one(k, budgets[k], scheduled)
            with lock:
                done[k] = (latency, ttft, budgets[k])

    stripe = min(n, 12)
    threads = [threading.Thread(target=worker, args=(i, stripe),
                                daemon=True)
               for i in range(stripe)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    finished = [d for d in done if d is not None]
    lats = np.asarray([d[0] for d in finished]) * 1e3
    short = np.asarray([d[0] for d in finished
                        if d[2] == min(budgets)]) * 1e3
    ttfts = np.asarray([d[1] for d in finished
                        if d[1] is not None]) * 1e3
    makespan = time.perf_counter() - start
    requested_tokens = sum(d[2] for d in finished)
    row: Dict[str, Any] = {
        "offered_rps": round(rate_rps, 1),
        "completed": len(finished),
        "makespan_s": round(makespan, 3),
        "goodput_tokens_per_s": round(requested_tokens / makespan, 1),
        "p50_ms": round(float(np.percentile(lats, 50)), 1),
        "p99_ms": round(float(np.percentile(lats, 99)), 1),
        "short_p50_ms": round(float(np.percentile(short, 50)), 1),
    }
    if ttfts.size:
        row["ttft_p50_ms"] = round(float(np.percentile(ttfts, 50)), 1)
    return row


def run_continuous_benchmark(config: ContinuousBenchConfig,
                             device: DeviceLike = None) -> Dict[str, Any]:
    """Per-rate static against continuous rows, the mid-decode-join
    TTFT probe and the bitwise verdicts, on a llama-test export."""
    from kubeflow_tpu_torch.inference import prng
    from kubeflow_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from kubeflow_tpu_torch.serving.manager import ModelManager

    manager = ModelManager(poll_interval_s=3600, device=device)
    base = _export(ServingBenchConfig(
        model="llama-test", prompt_len=config.prompt_len,
        new_tokens=config.long_tokens, max_batch=config.slots,
        model_dtype=config.model_dtype), manager.device)
    # One artifact, two serving stacks. The engine's capacity knobs ride
    # the export's generate_config: patch them in before either loads.
    meta_path = pathlib.Path(base) / "1" / "signature.json"
    meta = json.loads(meta_path.read_text())
    meta["generate_config"].update({
        "engine_slots": config.slots,
        "engine_page_size": config.page_size,
        "engine_slice_tokens": config.slice_tokens,
    })
    meta_path.write_text(json.dumps(meta))

    try:
        static_model = manager.add_model(
            "bench-static", base, max_batch=config.slots)
        cont_model = manager.add_model(
            "bench-cont", base, max_batch=config.slots,
            continuous_batching=True)
        rng = np.random.RandomState(7)
        prompts = rng.randint(
            0, 512, (config.num_requests, config.prompt_len)
        ).astype(np.int32)
        budgets = [config.short_tokens if i % 2 == 0
                   else config.long_tokens
                   for i in range(config.num_requests)]

        # Static capacity: one full coalesced batch, timed (requests/s
        # the static stack sustains with every slot full).
        t0 = time.perf_counter()
        futs = [static_model.submit(
            {"input_ids": prompts[i][None]}, None, "generate", None)
            for i in range(config.slots)]
        for f in futs:
            f.result(300)
        batch_s = time.perf_counter() - t0
        static_capacity_rps = config.slots / batch_s

        def submit_static(k, budget, scheduled):
            fut = static_model.submit(
                {"input_ids": prompts[k][None]}, None, "generate",
                None)
            fut.result(300)
            return time.perf_counter() - scheduled, None

        def submit_cont(k, budget, scheduled):
            _, (stream,) = cont_model.submit_stream(
                {"input_ids": prompts[k][None]}, None, None,
                max_new_tokens=budget)
            first = None
            for ev in stream.events(timeout_per_event=300):
                if first is None and not ev.final:
                    first = time.perf_counter() - scheduled
                if ev.final:
                    break
            stream.result(5)
            return time.perf_counter() - scheduled, first

        rows = []
        for x in config.rates_x:
            rate = static_capacity_rps * x
            static_row = _continuous_phase(
                submit_static, config.num_requests, rate, budgets)
            cont_row = _continuous_phase(
                submit_cont, config.num_requests, rate, budgets)
            rows.append({
                "offered_x": x,
                "static": static_row,
                "continuous": cont_row,
                "goodput_ratio": round(
                    cont_row["goodput_tokens_per_s"]
                    / max(static_row["goodput_tokens_per_s"], 1e-9),
                    3),
                "p50_ratio": round(
                    static_row["p50_ms"]
                    / max(cont_row["p50_ms"], 1e-9), 3),
            })

        loaded = cont_model.get_resident()
        engine = loaded.engine

        # TTFT probe: a short request admitted while a long neighbour
        # decodes must see its first token well before the neighbour's
        # whole decode ends (the static stack's floor for a late one).
        long_t0 = time.perf_counter()
        long_stream = engine.submit(prompts[1],
                                    max_new_tokens=config.long_tokens)
        assert long_stream.next_event(timeout=300) is not None
        short_t0 = time.perf_counter()
        short_stream = engine.submit(prompts[0],
                                     max_new_tokens=config.short_tokens)
        first_ev = short_stream.next_event(timeout=300)
        ttft_short_s = time.perf_counter() - short_t0
        short_stream.result(300)
        long_stream.result(300)
        long_decode_s = time.perf_counter() - long_t0
        assert first_ev is not None

        # Bitwise on live traffic. Greedy: explicit keys through the
        # SERVING engine while background rows churn. The B = 1 runs go
        # first, on this thread, while no engine runs: on the card an
        # engine may capture a graph when a shape first comes up, and a
        # capture must not overlap another thread's launches.
        module, params = loaded._module, loaded.params
        sampled = dict(temperature=0.8, top_k=50)
        greedy_keys = [prng.PRNGKey(4000 + i)
                       for i in range(config.equality_rows)]
        sampled_keys = [prng.PRNGKey(5000 + i)
                        for i in range(config.equality_rows)]
        greedy_want = [_b1(module, params, prompts[20 + i],
                           config.long_tokens, key)
                       for i, key in enumerate(greedy_keys)]
        sampled_want = [_b1(module, params, prompts[24 + i],
                            config.long_tokens, key, **sampled)
                        for i, key in enumerate(sampled_keys)]
        churn = [engine.submit(prompts[10 + i],
                               max_new_tokens=config.long_tokens)
                 for i in range(2)]
        greedy_ok = True
        for i, key in enumerate(greedy_keys):
            got = engine.submit(
                prompts[20 + i], rng=key,
                max_new_tokens=config.long_tokens).result(300)
            greedy_ok &= bool(np.array_equal(got, greedy_want[i]))
        for s in churn:
            s.result(300)

        # Sampled: a dedicated engine (the export is greedy).
        s_engine = DecodeEngine(module, params, EngineConfig(
            max_new_tokens=config.long_tokens,
            max_prompt_len=config.prompt_len, num_slots=2,
            page_size=config.page_size,
            slice_tokens=config.slice_tokens, **sampled),
            name="bench-sampled", device=loaded.device)
        sampled_ok = True
        try:
            streams = [s_engine.submit(prompts[24 + i], rng=key)
                       for i, key in enumerate(sampled_keys)]
            for s, want in zip(streams, sampled_want):
                sampled_ok &= bool(np.array_equal(s.result(300), want))
        finally:
            s_engine.stop()

        worst = max(config.rates_x)
        top = next(r for r in rows if r["offered_x"] == worst)
        return {
            "config": dataclasses.asdict(config),
            "static_capacity_rps": round(static_capacity_rps, 1),
            "static_batch_decode_ms": round(batch_s * 1e3, 1),
            "rows": rows,
            "ttft_short_ms": round(ttft_short_s * 1e3, 1),
            "long_decode_ms": round(long_decode_s * 1e3, 1),
            "ttft_vs_long_decode": round(
                ttft_short_s / max(long_decode_s, 1e-9), 3),
            "engine_stats": engine.stats(),
            "bitwise_greedy_ok": greedy_ok,
            "bitwise_sampled_ok": sampled_ok,
            "goodput_ratio_at_top": top["goodput_ratio"],
            "p50_ratio_at_top": top["p50_ratio"],
            "continuous_wins": bool(
                top["goodput_ratio"] > 1.0 and top["p50_ratio"] > 1.0
                and greedy_ok and sampled_ok
                and ttft_short_s < 0.5 * long_decode_s),
        }
    finally:
        manager.stop()
        _remove_export(base)


@dataclasses.dataclass
class PrefixBenchConfig:
    """Open-loop chat replay with a shared system prompt: every request
    is one of ``num_prefixes`` long system prefixes plus a short user
    suffix, driven at one arrival schedule against two engines of one
    model: the cold-prefill baseline (prefix cache off) and the
    prefix-cache engine. Reported: the hit rate and the mean-TTFT ratio
    (a hit prefills only the suffix's bucket), and the bitwise checks:
    warm outputs equal the B = 1 ``generate``'s, greedy and sampled, and
    a prefill-role handoff resumes equal."""

    model: str = "llama-test"
    system_prompt_len: int = 1000  # cold prefill pays the 1k bucket
    suffix_len: int = 8  # warm prefill pays the 8-token tail bucket
    max_prompt_len: int = 1024
    new_tokens: int = 8
    num_requests: int = 32
    num_prefixes: int = 3  # distinct "conversations" → ≥70% hit rate
    slots: int = 4
    page_size: int = 16
    slice_tokens: int = 4
    #: offered load as a fraction of the cold stack's prefill-bound
    #: capacity (open loop: queueing behind a slow server counts).
    rate_x: float = 0.7
    equality_rows: int = 3
    model_dtype: str = "float32"


def _prefix_phase(submit_one, n: int, rate_rps: float) -> Dict[str, Any]:
    """Open-loop drive measuring TTFT from the SCHEDULED arrival."""
    done: List[Any] = [None] * n
    lock = threading.Lock()
    start = time.perf_counter()
    interval = 1.0 / rate_rps

    def worker(i: int, stripe: int):
        for k in range(i, n, stripe):
            scheduled = start + k * interval
            delay = scheduled - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            ttft, total = submit_one(k, scheduled)
            with lock:
                done[k] = (ttft, total)

    stripe = min(n, 8)
    threads = [threading.Thread(target=worker, args=(i, stripe),
                                daemon=True) for i in range(stripe)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    finished = [d for d in done if d is not None]
    ttfts = np.asarray([d[0] for d in finished]) * 1e3
    makespan = time.perf_counter() - start
    return {
        "completed": len(finished),
        "offered_rps": round(rate_rps, 2),
        "makespan_s": round(makespan, 3),
        "mean_ttft_ms": round(float(np.mean(ttfts)), 2),
        "p50_ttft_ms": round(float(np.percentile(ttfts, 50)), 2),
        "p99_ttft_ms": round(float(np.percentile(ttfts, 99)), 2),
    }


def run_prefix_benchmark(config: PrefixBenchConfig,
                         device: DeviceLike = None) -> Dict[str, Any]:
    """Chat replay with a shared system prompt, the cold-prefill
    baseline against the prefix-cache engine at one offered load: the
    phase rows, the hit rate, the mean-TTFT ratio and the bitwise
    verdicts."""
    from kubeflow_tpu_torch.inference import prng
    from kubeflow_tpu_torch.inference.engine import DecodeEngine, EngineConfig

    model, params = _engine_model(
        config.model, config.model_dtype,
        config.max_prompt_len + config.new_tokens, device)
    device = next(iter(params.values())).device

    rng = np.random.RandomState(11)
    prefixes = [rng.randint(0, 512, (config.system_prompt_len,))
                .astype(np.int32) for _ in range(config.num_prefixes)]
    prompts = []
    for k in range(config.num_requests):
        suffix = rng.randint(0, 512,
                             (config.suffix_len,)).astype(np.int32)
        prompts.append(np.concatenate(
            [prefixes[k % config.num_prefixes], suffix]))

    def build(prefix_on: bool, name: str, **sampling):
        return DecodeEngine(model, params, EngineConfig(
            max_new_tokens=config.new_tokens,
            max_prompt_len=config.max_prompt_len,
            num_slots=config.slots, page_size=config.page_size,
            slice_tokens=config.slice_tokens,
            prefix_cache=prefix_on, **sampling), name=name, device=device)

    cold = build(False, "bench-prefix-cold")
    warm = build(True, "bench-prefix-warm")
    try:
        # Warm BOTH engines' paths off the clock (cold: a full-bucket
        # prefill and slices; warm: a miss AND a hit, which needs two
        # prompts of one conversation), then clear the warm engine's
        # index so the measured phase starts empty and pays its misses.
        key0 = prng.PRNGKey(1)
        same_conv = prompts[config.num_prefixes]  # same prefix as [0]
        for engine in (cold, warm):
            engine.submit(prompts[0], rng=key0).result(300)
            engine.submit(same_conv, rng=key0).result(300)
        warm.clear_prefix_cache()

        # The cold stack's prefill-bound service rate (one warmed
        # full-bucket request, timed).
        t0 = time.perf_counter()
        cold.submit(prompts[0], rng=key0).result(300)
        cold_request_s = time.perf_counter() - t0
        rate = config.rate_x / max(cold_request_s, 1e-6)

        def phase(engine):
            def submit_one(k, scheduled):
                stream = engine.submit(prompts[k])
                first = None
                for ev in stream.events(timeout_per_event=300):
                    if first is None and not ev.final:
                        first = time.perf_counter() - scheduled
                    if ev.final:
                        break
                return first, time.perf_counter() - scheduled
            return _prefix_phase(submit_one, config.num_requests, rate)

        cold_row = phase(cold)
        warm_row = phase(warm)
        prefix_stats = warm.stats()["prefix_cache"]
        hit_rate = prefix_stats["hit_rate"]

        # Bitwise: the warm engine against B = 1 generate, greedy (the
        # serving config), on live shared pages.
        greedy_ok = True
        for i in range(config.equality_rows):
            key = prng.PRNGKey(4000 + i)
            got = warm.submit(prompts[i], rng=key).result(300)
            want = _b1(model, params, prompts[i], config.new_tokens, key)
            greedy_ok &= bool(np.array_equal(got, want))

        # Sampled: a dedicated engine (the bench config is greedy).
        sampling = dict(temperature=0.8, top_k=50)
        s_warm = build(True, "bench-prefix-sampled", **sampling)
        sampled_ok = True
        try:
            for i in range(config.equality_rows):
                key = prng.PRNGKey(5000 + i)
                got = s_warm.submit(prompts[i], rng=key).result(300)
                want = _b1(model, params, prompts[i], config.new_tokens,
                           key, **sampling)
                sampled_ok &= bool(np.array_equal(got, want))
        finally:
            s_warm.stop()

        # Prefill role: a slot-bound run_prefill registers and hits the
        # prefix index. Two prefills of one conversation: the second
        # must hit, and each handoff must resume bitwise.
        hits_before = warm.stats()["prefix_cache"]["hits"]
        key_h = prng.PRNGKey(6000)
        handoffs = [warm.run_prefill(prompts[i], rng=key_h)
                    for i in (0, config.num_prefixes)]  # same prefix
        prefill_role_hits = (warm.stats()["prefix_cache"]["hits"]
                             - hits_before)
        handoff_ok = True
        for i, handoff in zip((0, config.num_prefixes), handoffs):
            got = warm.submit(handoff=handoff).result(300)
            want = _b1(model, params, prompts[i], config.new_tokens, key_h)
            handoff_ok &= bool(np.array_equal(got, want))

        ratio = cold_row["mean_ttft_ms"] / max(
            warm_row["mean_ttft_ms"], 1e-9)
        return {
            "config": dataclasses.asdict(config),
            "cold_request_ms": round(cold_request_s * 1e3, 2),
            "offered_rps": round(rate, 2),
            "cold": cold_row,
            "warm": warm_row,
            "prefix_stats": prefix_stats,
            "hit_rate": hit_rate,
            "mean_ttft_ratio": round(ratio, 2),
            "bitwise_greedy_ok": greedy_ok,
            "bitwise_sampled_ok": sampled_ok,
            "prefill_role_hits": prefill_role_hits,
            "bitwise_handoff_ok": handoff_ok,
            "prefix_wins": bool(hit_rate >= 0.7 and ratio >= 3.0
                                and greedy_ok and sampled_ok
                                and prefill_role_hits > 0
                                and handoff_ok),
        }
    finally:
        cold.stop()
        warm.stop()


@dataclasses.dataclass
class TieredPrefixBenchConfig:
    """A chat replay whose prefix working set is a multiple of the
    device page pool, the shape where a device-only prefix cache
    collapses (cyclic access over a working set larger than an LRU pool
    evicts every entry before its revisit), against two engines of one
    model: the baseline (host tier off) and the tiered engine (host-RAM
    spill pool). Reported: each engine's measured-phase hit rate, the
    tier's counters and the bitwise verdicts (warm == B = 1, greedy and
    sampled)."""

    model: str = "llama-test"
    #: Conversation shape: a per-conversation prefix of
    #: ``prefix_blocks`` full pages + a distinct short suffix per
    #: request (the suffix tail stays partial, so the retained working
    #: set is exactly conversations × prefix_blocks pages).
    prefix_blocks: int = 3
    suffix_len: int = 2
    page_size: int = 4
    #: Device pool: 10 pages (9 usable; page 0 is the null page), so 12
    #: conversations × 3 prefix blocks = 36 pages of working set is
    #: 4.0× the pool.
    num_pages: int = 10
    conversations: int = 12
    #: Measured cycles over the conversation set after one off-the-
    #: books warm cycle (which pays the compulsory misses).
    cycles: int = 3
    new_tokens: int = 7
    max_prompt_len: int = 24
    num_slots: int = 1
    slice_tokens: int = 3
    host_cache_bytes: int = 64 * 1024 * 1024
    equality_rows: int = 3
    model_dtype: str = "float32"


def run_tiered_prefix_benchmark(config: TieredPrefixBenchConfig,
                                device: DeviceLike = None
                                ) -> Dict[str, Any]:
    """One model, one set of prompts, one cyclic schedule; host tier off
    against on. The ``tier_stats`` block is the calibration document
    the reference's fleet simulator reads."""
    from kubeflow_tpu_torch.inference import prng
    from kubeflow_tpu_torch.inference.engine import DecodeEngine, EngineConfig

    prefix_len = config.prefix_blocks * config.page_size
    model, params = _engine_model(
        config.model, config.model_dtype,
        config.max_prompt_len + config.new_tokens + 1, device)
    device = next(iter(params.values())).device

    rng = np.random.RandomState(20)
    prefixes = [rng.randint(0, 512, (prefix_len,)).astype(np.int32)
                for _ in range(config.conversations)]

    def prompt_for(conv: int) -> np.ndarray:
        suffix = rng.randint(0, 512,
                             (config.suffix_len,)).astype(np.int32)
        return np.concatenate([prefixes[conv], suffix])

    def build(host_on: bool, name: str, **sampling) -> DecodeEngine:
        return DecodeEngine(model, params, EngineConfig(
            max_new_tokens=config.new_tokens,
            max_prompt_len=config.max_prompt_len,
            num_slots=config.num_slots, page_size=config.page_size,
            slice_tokens=config.slice_tokens, prefix_cache=True,
            num_pages=config.num_pages,
            host_cache_bytes=(config.host_cache_bytes
                              if host_on else 0),
            **sampling), name=name, device=device)

    def drive(engine: DecodeEngine) -> Dict[str, Any]:
        # Warm cycle: one request a conversation, the compulsory misses
        # that fill (and overflow) the pools. Off the books.
        for conv in range(config.conversations):
            engine.submit(prompt_for(conv)).result(300)
        before = engine.stats()["prefix_cache"]
        t0 = time.perf_counter()
        for _cycle in range(config.cycles):
            for conv in range(config.conversations):
                engine.submit(prompt_for(conv)).result(300)
        wall_s = time.perf_counter() - t0
        stats = engine.stats()
        after = stats["prefix_cache"]
        hits = after["hits"] - before["hits"]
        misses = after["misses"] - before["misses"]
        lookups = hits + misses
        n = config.cycles * config.conversations
        return {
            "requests": n,
            "measured_hits": hits,
            "measured_misses": misses,
            "effective_hit_rate": round(
                hits / lookups if lookups else 0.0, 4),
            "mean_request_ms": round(wall_s / n * 1e3, 2),
            "stats": stats,
        }

    baseline = build(False, "bench-tier-baseline")
    tiered = build(True, "bench-tier-host")
    try:
        base_row = drive(baseline)
        tier_row = drive(tiered)

        # Bitwise: tiered outputs (which rode host re-adopts) against
        # B = 1 generate, greedy (the serving config).
        greedy_ok = True
        for i in range(config.equality_rows):
            key = prng.PRNGKey(7000 + i)
            prompt = prompt_for(i)
            got = tiered.submit(prompt, rng=key).result(300)
            want = _b1(model, params, prompt, config.new_tokens, key)
            greedy_ok &= bool(np.array_equal(got, want))
    finally:
        baseline.stop()
        tiered.stop()

    # Sampled: a dedicated tiered engine, enough conversations to
    # overflow the pool and force re-adopts, then equality against the
    # sampled B = 1 generate.
    sampling = dict(temperature=0.8, top_k=50)
    s_tiered = build(True, "bench-tier-sampled", **sampling)
    sampled_ok = True
    try:
        for conv in range(config.conversations):
            s_tiered.submit(prompt_for(conv)).result(300)
        sampled_readopts_before = \
            s_tiered.stats()["kv_tier"]["host"]["readopted_blocks"]
        for i in range(config.equality_rows):
            key = prng.PRNGKey(8000 + i)
            prompt = prompt_for(i)
            got = s_tiered.submit(prompt, rng=key).result(300)
            want = _b1(model, params, prompt, config.new_tokens, key,
                       **sampling)
            sampled_ok &= bool(np.array_equal(got, want))
        sampled_readopts = (
            s_tiered.stats()["kv_tier"]["host"]["readopted_blocks"]
            - sampled_readopts_before)
    finally:
        s_tiered.stop()

    working_set_pages = config.conversations * config.prefix_blocks
    hbm_pool_pages = config.num_pages - 1
    tier_host = tier_row["stats"]["kv_tier"]["host"]
    tiering_holds = bool(
        tier_row["effective_hit_rate"] >= 0.7
        and base_row["effective_hit_rate"] < 0.3
        and tier_host["readopted_blocks"] > 0
        and sampled_readopts > 0
        and greedy_ok and sampled_ok)
    return {
        "config": dataclasses.asdict(config),
        "working_set_pages": working_set_pages,
        "hbm_pool_pages": hbm_pool_pages,
        "working_set_multiple": round(
            working_set_pages / hbm_pool_pages, 2),
        "baseline": {k: v for k, v in base_row.items()
                     if k != "stats"},
        "tiered": {k: v for k, v in tier_row.items()
                   if k != "stats"},
        "host_tier": tier_host,
        "sampled_readopted_blocks": sampled_readopts,
        "bitwise_greedy_ok": greedy_ok,
        "bitwise_sampled_ok": sampled_ok,
        "tier_stats": {
            "prefix_cache": {
                "hits": tier_row["measured_hits"],
                "misses": tier_row["measured_misses"],
                "hit_rate": tier_row["effective_hit_rate"],
            },
            "kv_tier": tier_row["stats"]["kv_tier"],
        },
        "tiering_holds": tiering_holds,
    }


@dataclasses.dataclass
class SpeculativeBenchConfig:
    """One verifier, three engines: vanilla decode (the baseline), a
    STRONG-draft speculative engine (the draft is the verifier itself:
    the acceptance ceiling, so the verifier forwards saved per emitted
    token show without a trained pair) and a WEAK-draft engine (a random
    1-layer d32 model at the verifier's vocab: acceptance near zero,
    which pins the safety property that the output stays bitwise the
    same however bad the draft). Reported: exactness and the acceptance
    economics; wall times are this run's."""

    model: str = "llama-test"
    prompt_len: int = 16
    new_tokens: int = 32
    num_requests: int = 6
    slots: int = 4
    page_size: int = 8
    slice_tokens: int = 4
    draft_tokens: int = 3
    equality_rows: int = 3
    model_dtype: str = "float32"


def run_speculative_benchmark(config: SpeculativeBenchConfig,
                              device: DeviceLike = None) -> Dict[str, Any]:
    """The same requests through vanilla / strong-draft / weak-draft
    engines: each engine's acceptance and forwards-per-token row and the
    bitwise verdicts (greedy and sampled)."""
    from kubeflow_tpu_torch.inference import prng
    from kubeflow_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from kubeflow_tpu_torch.models.convert import init_params
    from kubeflow_tpu_torch.models.llama import Llama

    model, params = _engine_model(
        config.model, config.model_dtype,
        config.prompt_len + config.new_tokens + config.draft_tokens + 1,
        device)
    device = next(iter(params.values())).device
    # The weak draft: the verifier's vocab and cache geometry (the
    # engine's compatibility contract), everything else minimal.
    weak_model = Llama(vocab_size=model.vocab_size, num_layers=1,
                       d_model=32, num_heads=2, num_kv_heads=1,
                       mlp_dim=64, cache_size=model.cache_size,
                       dtype=config.model_dtype)
    weak_params = init_params(weak_model, seed=99, device=device)

    def build(name: str, *, draft=None, dparams=None, **sampling):
        k = config.draft_tokens if draft is not None else 0
        return DecodeEngine(model, params, EngineConfig(
            max_new_tokens=config.new_tokens,
            max_prompt_len=config.prompt_len,
            num_slots=config.slots, page_size=config.page_size,
            slice_tokens=config.slice_tokens, speculate_tokens=k,
            **sampling), name=name, device=device, draft_model=draft,
            draft_params=dparams)

    rng = np.random.RandomState(16)
    prompts = [rng.randint(0, model.vocab_size,
                           (config.prompt_len,)).astype(np.int32)
               for _ in range(config.num_requests)]
    keys = [prng.PRNGKey(7000 + i) for i in range(config.num_requests)]

    engines = {
        "vanilla": build("bench-spec-vanilla"),
        "strong": build("bench-spec-strong", draft=model,
                        dparams=params),
        "weak": build("bench-spec-weak", draft=weak_model,
                      dparams=weak_params),
    }
    emitted = {name: 0 for name in engines}

    def drive(name: str) -> Tuple[List[np.ndarray], float]:
        engine = engines[name]
        # Warm the programs off the clock.
        out = engine.submit(prompts[0], rng=keys[0]).result(300)
        emitted[name] += len(out)
        t0 = time.perf_counter()
        streams = [engine.submit(prompts[i], rng=keys[i])
                   for i in range(config.num_requests)]
        results = [s.result(300) for s in streams]
        wall = time.perf_counter() - t0
        emitted[name] += sum(len(r) for r in results)
        return results, wall

    try:
        outs, walls = {}, {}
        for name in engines:
            outs[name], walls[name] = drive(name)

        # Bitwise (greedy): both spec engines == vanilla == B = 1.
        greedy_ok = True
        for i in range(min(config.equality_rows, config.num_requests)):
            want = _b1(model, params, prompts[i], config.new_tokens,
                       keys[i])
            for name in engines:
                greedy_ok &= bool(np.array_equal(outs[name][i], want))

        rows: Dict[str, Any] = {}
        for name, engine in engines.items():
            stats = engine.stats()
            row: Dict[str, Any] = {
                "wall_s": round(walls[name], 3),
                "tokens_per_s": round(
                    sum(len(r) for r in outs[name]) / walls[name], 1),
            }
            if "spec" in stats:
                spec = stats["spec"]
                # Per-SLOT verifier economics: a slot emits 1..k+1 tokens
                # a verifier forward it joins; vanilla emits exactly 1.
                # drafted_tokens grows by exactly k a slot a round, so
                # drafted/k counts the slot-rounds.
                slot_rounds = spec["drafted_tokens"] // max(
                    spec["k"], 1)
                row.update({
                    "k": spec["k"],
                    "acceptance_rate": spec["acceptance_rate"],
                    "drafted_tokens": spec["drafted_tokens"],
                    "accepted_tokens": spec["accepted_tokens"],
                    "batched_verify_forwards": spec["verify_forwards"],
                    "verify_forwards_per_token": round(
                        slot_rounds / max(emitted[name], 1), 4),
                })
            rows[name] = row

        # Sampled: a dedicated strong-draft engine against B = 1: the
        # draws come out bitwise the same because targets are sampled
        # from the VERIFIER's logits with the slot's own step keys.
        sampling = dict(temperature=0.8, top_k=50)
        s_engine = build("bench-spec-sampled", draft=model,
                         dparams=params, **sampling)
        sampled_ok = True
        try:
            for i in range(min(config.equality_rows,
                               config.num_requests)):
                got = s_engine.submit(prompts[i],
                                      rng=keys[i]).result(300)
                want = _b1(model, params, prompts[i], config.new_tokens,
                           keys[i], **sampling)
                sampled_ok &= bool(np.array_equal(got, want))
            sampled_acceptance = \
                s_engine.stats()["spec"]["acceptance_rate"]
        finally:
            s_engine.stop()

        strong = rows["strong"]
        return {
            "config": dataclasses.asdict(config),
            "rows": rows,
            "sampled_acceptance_rate": sampled_acceptance,
            "bitwise_greedy_ok": greedy_ok,
            "bitwise_sampled_ok": sampled_ok,
            "acceptance_rate": strong["acceptance_rate"],
            "verify_forwards_per_token":
                strong["verify_forwards_per_token"],
            "wall_ratio_vs_vanilla": round(
                walls["vanilla"] / max(walls["strong"], 1e-9), 3),
            "speculative_wins": bool(
                greedy_ok and sampled_ok
                and strong["acceptance_rate"] > 0.0
                and strong["verify_forwards_per_token"] < 1.0),
        }
    finally:
        for engine in engines.values():
            engine.stop()


@dataclasses.dataclass
class TenantBenchConfig:
    """The noisy-neighbour isolation sweep. Four tenants share one
    ``ServedModel``: ONE noisy tenant offers 4× its quota while three
    compliant tenants each offer 0.8× of theirs, over a sleep-priced
    stub model (so the ratios are scheduling policy, not the host's CPU
    weather), in two phases:

    - **isolation off** (no tenancy registry): every request meets one
      FIFO and one admission controller, and the noisy flood's shed
      falls on everyone;
    - **isolation on** (registry, per-tenant buckets, weighted-fair
      queue): the noisy tenant's excess bounces as ITS OWN 429s before
      it touches the queue, and every compliant request is served
      inside its deadline.

    The invariant: with isolation on, no compliant tenant's p99 passes
    its deadline, and compliant tenants see ZERO quota sheds."""

    max_batch: int = 4
    service_time_s: float = 0.02  # per dispatch ⇒ capacity ≈
    # max_batch / service_time ≈ 200 rps on any box
    deadline_ms: float = 250.0
    phase_seconds: float = 4.0
    noisy_x: float = 4.0      # noisy tenant's offered ÷ its quota
    compliant_x: float = 0.8  # compliant tenants' offered ÷ quota
    compliant_tenants: int = 3
    queue_capacity: int = 4096


class _SleepStub:
    """A sleep-priced ``LoadedModel`` stand-in: one dispatch costs
    exactly ``service_time_s`` whatever the host is doing."""

    version = 1

    def __init__(self, service_time_s: float):
        self.service_time_s = service_time_s
        self.calls = 0
        self._lock = threading.Lock()

    def signature(self, name=None):
        class Sig:
            method = "predict"
            inputs = {"x": None}
        return Sig()

    def run(self, inputs, sig_name=None, method=None):
        with self._lock:
            self.calls += 1
        time.sleep(self.service_time_s)
        x = np.asarray(inputs["x"])
        return {"y": x * 2.0}


def _tenant_drive(model, tenants: Dict[str, float],
                  duration_s: float, deadline_ms: float
                  ) -> Dict[str, Dict[str, Any]]:
    """Open-loop multi-tenant drive: each tenant fires at its own fixed
    arrival rate (the ``tenant=`` submit argument standing in for its
    header); outcomes are counted per tenant. A noisy neighbour does not
    slow down because the server does."""
    import concurrent.futures

    from kubeflow_tpu_torch.serving import overload

    budget_s = deadline_ms / 1e3
    results: Dict[str, List[Any]] = {t: [] for t in tenants}
    lock = threading.Lock()
    inputs = {"x": np.ones((1, 2), np.float32)}

    def one(tenant: str) -> None:
        t0 = time.perf_counter()
        deadline = overload.deadline_after(budget_s)
        try:
            future = model.submit(inputs, None, None, None,
                                  deadline=deadline, tenant=tenant)
            future.result(budget_s + 1.0)
            outcome = "ok"
        except overload.QuotaExceededError:
            outcome = "quota"
        except overload.OverloadedError:
            outcome = "shed"
        except overload.DeadlineExceededError:
            outcome = "expired"
        except concurrent.futures.TimeoutError:
            outcome = "client_timeout"
        with lock:
            results[tenant].append(
                (outcome, time.perf_counter() - t0))

    threads = []
    start = time.perf_counter()
    for tenant, rate in tenants.items():
        n = max(1, int(rate * duration_s))
        interval = 1.0 / rate
        pool = min(n, max(8, int(rate * budget_s * 1.5) + 1))

        def worker(i: int, tenant=tenant, n=n, interval=interval,
                   pool=pool) -> None:
            for k in range(i, n, pool):
                delay = start + k * interval - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                one(tenant)

        threads.extend(
            threading.Thread(target=worker, args=(i,), daemon=True)
            for i in range(pool))
    for t in threads:
        t.start()
    for t in threads:
        t.join(duration_s + budget_s + 30)
    out: Dict[str, Dict[str, Any]] = {}
    for tenant, rows in results.items():
        counts: Dict[str, int] = {}
        for outcome, _ in rows:
            counts[outcome] = counts.get(outcome, 0) + 1
        ok_lat = np.asarray([lat for outcome, lat in rows
                             if outcome == "ok"]) * 1e3
        row: Dict[str, Any] = {
            "sent": len(rows),
            "ok": counts.get("ok", 0),
            "quota": counts.get("quota", 0),
            "shed": counts.get("shed", 0),
            "expired": counts.get("expired", 0),
            "client_timeout": counts.get("client_timeout", 0),
        }
        if ok_lat.size:
            row["ok_p50_ms"] = round(float(np.percentile(ok_lat, 50)),
                                     1)
            row["ok_p99_ms"] = round(float(np.percentile(ok_lat, 99)),
                                     1)
        out[tenant] = row
    return out


def run_tenant_benchmark(config: TenantBenchConfig,
                         device: DeviceLike = None) -> Dict[str, Any]:
    """Isolation off, then on, over the sleep stub. ``device`` is the
    ``ServedModel``'s (the stub runs no model on it)."""
    from kubeflow_tpu_torch.serving import tenancy
    from kubeflow_tpu_torch.serving.manager import ServedModel

    capacity = config.max_batch / config.service_time_s
    fair_share = capacity / (1 + config.compliant_tenants)
    compliant = [f"compliant-{i}"
                 for i in range(config.compliant_tenants)]
    rates = {"noisy": config.noisy_x * fair_share}
    rates.update({t: config.compliant_x * fair_share
                  for t in compliant})

    def build(registry):
        m = ServedModel("tenant-bench", "/nonexistent",
                        max_batch=config.max_batch,
                        batch_window_s=0.001,
                        queue_capacity=config.queue_capacity,
                        tenancy_registry=registry, device=device)
        m._versions[1] = _SleepStub(config.service_time_s)
        m._latest = 1
        # Admission control needs a truthful latency prior from the
        # first request on (a real server seeds it from warmup).
        m._latency.seed(config.service_time_s)
        return m

    phases: Dict[str, Any] = {}
    for mode in ("isolation_off", "isolation_on"):
        registry = None
        if mode == "isolation_on":
            registry = tenancy.TenantRegistry(tenancy.TenantPolicy(
                default=tenancy.TenantQuota(
                    requests_per_s=fair_share,
                    request_burst=max(4.0, fair_share / 2))))
        model = build(registry)
        try:
            rows = _tenant_drive(model, rates,
                                 config.phase_seconds,
                                 config.deadline_ms)
            stats = model.batch_stats()
        finally:
            model.stop()
        phases[mode] = {"tenants": rows, "server": stats}

    on = phases["isolation_on"]["tenants"]
    off = phases["isolation_off"]["tenants"]

    def worst_compliant(rows, field, default):
        return max((rows[t].get(field, default) for t in compliant),
                   default=default)

    compliant_p99_on = worst_compliant(on, "ok_p99_ms", 0.0)
    isolation_ok = (
        # 1. no compliant p99 past the deadline,
        compliant_p99_on <= config.deadline_ms
        # 2. never a shed for someone else's burst: compliant tenants
        #    see no quota 429s,
        and worst_compliant(on, "quota", 0) == 0
        # 3. every compliant tenant is actually served,
        and all(on[t]["ok"] >= 0.95 * on[t]["sent"]
                for t in compliant)
        # 4. and the noisy tenant's excess bounced as ITS OWN 429s.
        and on["noisy"]["quota"] > 0)
    compliant_failed_off = sum(
        off[t]["sent"] - off[t]["ok"] for t in compliant)
    compliant_failed_on = sum(
        on[t]["sent"] - on[t]["ok"] for t in compliant)
    return {
        "config": dataclasses.asdict(config),
        "capacity_rps": round(capacity, 1),
        "fair_share_rps": round(fair_share, 1),
        "offered_rates_rps": {t: round(r, 1)
                              for t, r in rates.items()},
        "phases": phases,
        "compliant_p99_on_ms": compliant_p99_on,
        "compliant_p99_off_ms": worst_compliant(off, "ok_p99_ms",
                                                0.0),
        "compliant_failed_off": compliant_failed_off,
        "compliant_failed_on": compliant_failed_on,
        "noisy_quota_sheds": on["noisy"]["quota"],
        "isolation_ok": isolation_ok,
    }


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="kft-serving-bench")
    parser.add_argument("--model", default="inception-v3")
    parser.add_argument("--image_hw", type=int, default=299)
    parser.add_argument("--clients", type=int, default=4)
    parser.add_argument("--requests_per_client", type=int, default=32)
    parser.add_argument("--transport", default="http",
                        choices=("http", "grpc", "both"),
                        help="http and both need tornado")
    parser.add_argument("--sweep", default="",
                        help="comma-separated client counts, e.g. 1,2,4,8")
    parser.add_argument("--max_batch", type=int, default=4)
    parser.add_argument("--prompt_len", type=int, default=32,
                        help="language models: prompt length of the "
                             ":generate requests")
    parser.add_argument("--new_tokens", type=int, default=16,
                        help="language models: tokens generated per "
                             "request (set at export)")
    parser.add_argument("--model_dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="export/serve dtype ('bfloat16' for "
                             "real-size LLMs; 'float32' keeps toy "
                             "comparisons exact)")
    parser.add_argument("--port", type=int, default=0,
                        help="0 = ephemeral")
    parser.add_argument("--mixed", action="store_true",
                        help="mixed-load mode: classify p50/p99 alone "
                             "vs under a continuous generate stream "
                             "(one server, one device); ignores "
                             "--model/--transport")
    parser.add_argument("--new_tokens_mixed", type=int, default=64,
                        help="mixed mode: decode length per generate "
                             "request")
    parser.add_argument("--generate_clients", type=int, default=2,
                        help="mixed mode: continuous generate streamers")
    parser.add_argument("--decode_chunk", type=int, default=0,
                        help="mixed mode: decode-slicing K (0 = "
                             "monolithic decode)")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = args.device
    if args.mixed:
        result = run_mixed_load_benchmark(MixedLoadConfig(
            classify_clients=args.clients,
            classify_requests=args.requests_per_client,
            generate_clients=args.generate_clients,
            prompt_len=args.prompt_len,
            new_tokens=args.new_tokens_mixed,
            model_dtype=args.model_dtype,
            decode_chunk=args.decode_chunk or None,
        ), device)
        print(json.dumps(result))
        return 0
    rejection = _encoder_rejection(args.model)
    if rejection:
        # run_serving_benchmark's own check, as an argparse error so the
        # CLI fails at once, not at model load.
        parser.error(rejection)
    sweep: Sequence[int] = tuple(
        int(s) for s in args.sweep.split(",") if s.strip())
    result = run_serving_benchmark(ServingBenchConfig(
        model=args.model, image_hw=args.image_hw, clients=args.clients,
        requests_per_client=args.requests_per_client,
        max_batch=args.max_batch, port=args.port,
        transport=args.transport, sweep_clients=sweep,
        prompt_len=args.prompt_len, new_tokens=args.new_tokens,
        model_dtype=args.model_dtype), device)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
