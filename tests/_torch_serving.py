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

"""Shared helpers of the port's serving tests (not a test module).

Exports are written by the reference's ``export_model`` from the
reference's ``llama-test`` fp32 params, so a JAX replica and a port
replica serve the same version dir. ``serve`` runs a tornado app on a
real loopback socket with its IOLoop on a background thread, as the
reference's serving tests do.
"""

import asyncio
import http.client
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp

from kubeflow_tpu.models.llama import llama_test
from kubeflow_tpu.serving import wire as jax_wire
from kubeflow_tpu.serving.export import export_model
from kubeflow_tpu.serving.signature import (
    ModelMetadata,
    Signature,
    TensorSpec,
)

PROMPT_LEN = 8
NEW_TOKENS = 6
CACHE = 32

#: The engine knobs of the reference's streaming and fault fleets.
ENGINE = {"engine_slots": 2, "engine_page_size": 8,
          "engine_slice_tokens": 2}
GREEDY = {"max_new_tokens": NEW_TOKENS, "temperature": 0.0}
#: Sampled, with per-request keys pinned (``deterministic``), so two
#: replicas given the same request draw the same keys.
SAMPLED = {"max_new_tokens": NEW_TOKENS, "temperature": 0.8,
           "seed": 11, "deterministic": True}


def export_generate(base, generate_config, *, prompt_len=PROMPT_LEN,
                    new_tokens=NEW_TOKENS, version=1, seed=0):
    """A generate-signature ``llama-test`` fp32 export at ``base``."""
    model = llama_test(dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, prompt_len), jnp.int32))
    meta = ModelMetadata(
        model_name="m", registry_name="llama-test",
        model_kwargs={"dtype": "float32", "cache_size": CACHE},
        signatures={"serving_default": Signature(
            method="generate",
            inputs={"input_ids": TensorSpec("int32", (-1, prompt_len))},
            outputs={"tokens": TensorSpec("int32", (-1, new_tokens))})},
        generate_config=dict(generate_config))
    export_model(str(base), version, meta, {"params": variables["params"]})
    return base


def export_predict(base, *, seq=16, version=1, seed=0):
    """A predict-signature ``llama-test`` fp32 export (logits
    ``[-1, seq, 512]``; ``:classify`` runs on the same signature)."""
    model = llama_test(dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, seq), jnp.int32))
    meta = ModelMetadata(
        model_name="p", registry_name="llama-test",
        model_kwargs={"dtype": "float32"},
        signatures={"serving_default": Signature(
            method="predict",
            inputs={"input_ids": TensorSpec("int32", (-1, seq))},
            outputs={"logits": TensorSpec("float32", (-1, seq, 512))})})
    export_model(str(base), version, meta, {"params": variables["params"]})
    return base


class Served:
    """A tornado app on 127.0.0.1 with its IOLoop on a daemon thread."""

    def __init__(self, factory):
        self.port = 0
        self.loop = None
        started = threading.Event()

        def run():
            import tornado.ioloop

            asyncio.set_event_loop(asyncio.new_event_loop())
            server = factory().listen(0)
            self.port = next(iter(
                server._sockets.values())).getsockname()[1]
            self.loop = tornado.ioloop.IOLoop.current()
            started.set()
            self.loop.start()

        threading.Thread(target=run, daemon=True).start()
        assert started.wait(120), "server thread never started"

    @property
    def address(self):
        return f"127.0.0.1:{self.port}"

    def stop(self):
        self.loop.add_callback(self.loop.stop)


def post(port, path, body, headers=None, timeout=120):
    """POST JSON; returns (status, raw body bytes)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def unary_tokens(port, rows, model="m", prefix="/v1/models"):
    status, raw = post(port, f"{prefix}/{model}:generate",
                       {"instances": rows})
    assert status == 200, raw
    return [p["tokens"] for p in json.loads(raw)["predictions"]]


def stream_events(port, path, body, *, stop_after=None, timeout=120):
    """Stream an SSE ``:generate``; with ``stop_after`` the client hangs
    up after that many ``token`` events (a replica death as the stream
    sees it). Returns the ``(event, data)`` pairs read."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200, resp.read()
    events, tokens = [], 0
    for event, data in jax_wire.iter_sse_events(resp):
        events.append((event, data))
        tokens += event == "token"
        if stop_after is not None and tokens >= stop_after:
            break
    conn.close()
    return events
