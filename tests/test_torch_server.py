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

"""The port's model server (``make_app``, ``make_server``) against the
reference's, on real loopback sockets.

Twins of tests/test_serving_generate.py, tests/test_serving_batch_
generate.py and the stack half of tests/test_streaming_wire.py, with a
port replica where the reference had its own. The port's answers are
held to a JAX replica's over the same export: the unary ``:generate``
body, the gRPC Predict reply, the gRPC-Web replies and the status and
metadata documents byte for byte, the SSE and gRPC streams token for
token, greedy and sampled (a deterministic export, so both replicas
draw the same keys). The reference's proxy and client drive the port
server unchanged.
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest

from kubeflow_tpu.inference import generate as jax_generate
from kubeflow_tpu.serving import client as ref_client
from kubeflow_tpu.serving import wire as jax_wire
from kubeflow_tpu.serving.grpc_server import make_server as jax_grpc
from kubeflow_tpu.serving.http_proxy import make_app as proxy_app
from kubeflow_tpu.serving.manager import ModelManager as JaxManager
from kubeflow_tpu.serving.model import load_version as jax_load_version
from kubeflow_tpu.serving.server import make_app as jax_app
from kubeflow_tpu_torch.serving import wire
from kubeflow_tpu_torch.serving.grpc_server import make_server
from kubeflow_tpu_torch.serving.manager import ModelManager
from kubeflow_tpu_torch.serving.server import make_app
from tests._torch_serving import (
    ENGINE,
    GREEDY,
    NEW_TOKENS,
    PROMPT_LEN,
    SAMPLED,
    Served,
    export_generate,
    post,
    stream_events,
    unary_tokens,
)

MODELS = {"g": GREEDY, "m": SAMPLED}


def _rows(n, seed=1, length=PROMPT_LEN):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 512, (n, length)).tolist()


# -- the static (micro-batched) generate server ------------------------------


@pytest.fixture(scope="module")
def static(tmp_path_factory):
    """The port server over a greedy static export, its batch window
    widened so that concurrent requests coalesce (the contract under
    test), plus the reference's proxy in front of it and the
    reference's loaded version for the expected tokens."""
    base = export_generate(tmp_path_factory.mktemp("static") / "s", GREEDY)
    mgr = ModelManager(poll_interval_s=3600, device="cpu")
    model = mgr.add_model("tinyllama", str(base), max_batch=8)
    model.batch_window_s = 0.25
    server = Served(lambda: make_app(mgr))
    proxy = Served(lambda: proxy_app(f"http://127.0.0.1:{server.port}"))
    ref = jax_load_version(str(base / "1"), max_batch=8)
    yield {"server": server, "proxy": proxy, "model": model, "ref": ref,
           "manager": mgr}
    proxy.stop()
    server.stop()
    mgr.stop()


def _concurrent(static, prompts):
    results, errors = [None] * len(prompts), []
    barrier = threading.Barrier(len(prompts))

    def client(i):
        try:
            barrier.wait()
            results[i] = unary_tokens(static["server"].port,
                                      [prompts[i]], "tinyllama")[0]
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors[:3]
    return results


@pytest.mark.parametrize("lengths", [(8,) * 6, (3, 8, 5, 8, 4)],
                         ids=["equal_lengths", "mixed_lengths"])
def test_concurrent_generates_coalesce_and_equal_sequential(static,
                                                            lengths):
    """N concurrent ``:generate`` requests ride fewer than N decode
    executions, and each request's tokens are its sequential B=1 run's
    and the reference's."""
    rng = np.random.RandomState(len(set(lengths)))
    prompts = [rng.randint(0, 512, (n,)).tolist() for n in lengths]
    port = static["server"].port
    sequential = [unary_tokens(port, [p], "tinyllama")[0] for p in prompts]
    static["model"].batch_stats(reset=True)
    results = _concurrent(static, prompts)
    stats = static["model"].batch_stats()
    assert stats["rows"] == len(prompts)
    assert stats["batches"] < len(prompts), stats
    assert results == sequential
    for p, got in zip(prompts, results):
        want = static["ref"].run({"input_ids": np.asarray([p])})["tokens"]
        assert got == want[0].tolist()


def test_generate_roundtrip_wrong_verb_and_overlength(static):
    port = static["server"].port
    rows = [[7] * PROMPT_LEN, [11] * PROMPT_LEN]
    status, raw = post(port, "/v1/models/tinyllama:generate",
                       {"instances": rows})
    assert status == 200, raw
    preds = json.loads(raw)["predictions"]
    want = static["ref"].run({"input_ids": np.asarray(rows)})["tokens"]
    assert [p["tokens"] for p in preds] == want.tolist()
    assert post(port, "/v1/models/tinyllama:generate",
                {"instances": rows})[1] == raw
    assert post(port, "/v1/models/tinyllama:predict",
                {"instances": [[1] * PROMPT_LEN]})[0] == 400
    assert post(port, "/v1/models/tinyllama:generate",
                {"instances": [[1] * (PROMPT_LEN + 1)]})[0] == 400


def test_short_prompt_equals_direct_generate(static):
    """A shorter-than-signature prompt through the server equals the
    reference's direct library run on the UNPADDED prompt."""
    from kubeflow_tpu.models.llama import llama_test
    import jax.numpy as jnp

    prompt = np.asarray(_rows(1, seed=12, length=5), np.int32)
    got = unary_tokens(static["server"].port, prompt.tolist(),
                       "tinyllama")[0]
    model = llama_test(dtype=jnp.float32, cache_size=32)
    want, _ = jax_generate(model, static["ref"].variables["params"],
                           jnp.asarray(prompt), max_new_tokens=NEW_TOKENS,
                           temperature=0.0)
    assert got == np.asarray(want)[0].tolist()


def test_proxy_generate_in_front_of_the_port(static):
    got = unary_tokens(static["proxy"].port, [[3] * PROMPT_LEN],
                       "tinyllama", prefix="/model")
    want = static["ref"].run(
        {"input_ids": np.full((1, PROMPT_LEN), 3, np.int32)})["tokens"]
    assert got == want.tolist()


def test_native_grpc_predict_runs_generate_signature(static):
    grpc = pytest.importorskip("grpc")
    server, port = make_server(static["manager"], 0)
    server.start()
    try:
        prompt = np.asarray(_rows(1, seed=3), np.int32)
        request = wire.encode_predict_request(
            "tinyllama", {"input_ids": prompt})
        with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
            reply = channel.unary_unary(
                "/tensorflow.serving.PredictionService/Predict"
            )(request, timeout=60.0)
        _, outputs = jax_wire.decode_predict_response(reply)
        want = static["ref"].run({"input_ids": prompt})["tokens"]
        np.testing.assert_array_equal(outputs["tokens"], want)
        assert reply == jax_wire.encode_predict_response(
            {"tokens": want}, "tinyllama", 1)
    finally:
        server.stop(grace=None)


# -- the streaming stack: port replica beside a JAX replica ------------------


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """Both packages' managers (continuous batching) over the same two
    exports, greedy ``g`` and sampled ``m``: REST and gRPC servers of
    each, and the reference's pooled proxy in front of the port's."""
    root = tmp_path_factory.mktemp("stream")
    bases = {name: export_generate(root / name, {**cfg, **ENGINE})
             for name, cfg in MODELS.items()}
    port_mgr = ModelManager(poll_interval_s=3600, device="cpu")
    jax_mgr = JaxManager(poll_interval_s=3600)
    for name, base in bases.items():
        port_mgr.add_model(name, str(base), max_batch=2,
                           continuous_batching=True)
        jax_mgr.add_model(name, str(base), max_batch=2,
                          continuous_batching=True)
    rest = Served(lambda: make_app(port_mgr))
    jrest = Served(lambda: jax_app(jax_mgr))
    gsrv, gport = make_server(port_mgr, 0)
    gsrv.start()
    jgsrv, jgport = jax_grpc(jax_mgr, 0)
    jgsrv.start()
    proxy = Served(lambda: proxy_app(rpc_address=rest.address,
                                     grpc_address=f"127.0.0.1:{gport}"))
    yield {"rest": rest.port, "jax_rest": jrest.port, "grpc": gport,
           "jax_grpc": jgport, "proxy": proxy.port, "manager": port_mgr}
    for s in (proxy, rest, jrest):
        s.stop()
    gsrv.stop(grace=1)
    jgsrv.stop(grace=1)
    port_mgr.stop()
    jax_mgr.stop()


@pytest.mark.parametrize("model", list(MODELS))
def test_unary_generate_body_is_the_reference_byte_for_byte(stack, model):
    rows = _rows(2, seed=21)
    path = f"/v1/models/{model}:generate"
    status, ours = post(stack["rest"], path, {"instances": rows})
    assert status == 200, ours
    assert ours == post(stack["jax_rest"], path, {"instances": rows})[1]


@pytest.mark.parametrize("model", list(MODELS))
def test_sse_stream_grammar_and_unary_equality(stack, model):
    """Wire conformance against the live engine: token* then one
    terminal done, per-row sequential indexes, the streamed tokens the
    unary answer's, and the done frame the JAX replica's."""
    rows = _rows(2)
    ref = unary_tokens(stack["rest"], rows, model)
    path = f"/v1/models/{model}:generate"
    events = stream_events(stack["rest"], path,
                           {"instances": rows, "stream": True})
    theirs = stream_events(stack["jax_rest"], path,
                           {"instances": rows, "stream": True})
    assert [e for e, _ in events if e == "done"] == ["done"]
    assert events[-1][0] == "done"
    per_row = {0: [], 1: []}
    for event, data in events[:-1]:
        assert event == "token", event
        assert data["index"] == len(per_row[data["row"]])
        per_row[data["row"]].append(data["token"])
    assert [per_row[0], per_row[1]] == ref
    assert events[-1] == theirs[-1]
    assert events[-1][1]["tokens"] == ref


def test_streaming_requires_generate_verb_and_accept_negotiates(stack):
    status, raw = post(stack["rest"], "/v1/models/g:predict",
                       {"instances": _rows(1), "stream": True})
    assert status == 400 and ":generate" in json.loads(raw)["error"]
    conn = http.client.HTTPConnection("127.0.0.1", stack["rest"],
                                      timeout=120)
    conn.request("POST", "/v1/models/g:generate",
                 body=json.dumps({"instances": _rows(1)}),
                 headers={"Content-Type": "application/json",
                          "Accept": wire.SSE_CONTENT_TYPE})
    resp = conn.getresponse()
    assert resp.headers["Content-Type"].startswith(wire.SSE_CONTENT_TYPE)
    events = list(jax_wire.iter_sse_events(resp))
    conn.close()
    assert events[-1][0] == "done"


@pytest.mark.parametrize("budget", [None, 3], ids=["full", "budget3"])
def test_client_helper_streams_through_proxy(stack, budget):
    """The reference's ``stream_generate`` through the reference's
    proxy in front of the port: the tokens the backend decoded, cut at
    a per-request budget."""
    rows = _rows(1, seed=5)
    ref = unary_tokens(stack["rest"], rows, "m")[0][:budget]
    got, done = [], None
    for event, data in ref_client.stream_generate(
            f"127.0.0.1:{stack['proxy']}", "m", rows,
            max_new_tokens=budget):
        if event == "token":
            got.append(data["token"])
        elif event == "done":
            done = data
    assert got == ref
    assert done["tokens"][0] == ref


def test_grpc_generate_stream_matches_unary_and_the_reference(stack):
    rows = _rows(2, seed=13)
    ref = unary_tokens(stack["rest"], rows, "m")
    for port in (stack["grpc"], stack["jax_grpc"]):
        per_row, final = {0: [], 1: []}, None
        for event, data in ref_client.grpc_generate_stream(
                f"127.0.0.1:{port}", "m", {"input_ids": rows},
                timeout=120):
            if event == "token":
                assert data["index"] == len(per_row[data["row"]])
                per_row[data["row"]].append(data["token"])
            else:
                final = data
        assert [per_row[0], per_row[1]] == ref
        assert [list(r) for r in final["tokens"]] == ref


def test_grpc_predict_and_grpc_web_replies_are_the_reference(stack):
    """Predict over native gRPC and Predict / GetModelMetadata over
    gRPC-Web: the port's reply bytes are the JAX replica's."""
    import grpc

    prompt = np.asarray(_rows(1, seed=8), np.int32)
    request = wire.encode_predict_request("g", {"input_ids": prompt})
    replies = []
    for port in (stack["grpc"], stack["jax_grpc"]):
        with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
            replies.append(channel.unary_unary(
                "/tensorflow.serving.PredictionService/Predict"
            )(request, timeout=60.0))
    assert replies[0] == replies[1]
    meta_req = wire.encode_get_model_metadata_request("g")
    for method, body in (("Predict", request),
                         ("GetModelMetadata", meta_req)):
        got = []
        for port in (stack["rest"], stack["jax_rest"]):
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=60)
            conn.request(
                "POST", f"/tensorflow.serving.PredictionService/{method}",
                body=wire.frame_message(body),
                headers={"Content-Type": "application/grpc-web+proto"})
            got.append(conn.getresponse().read())
            conn.close()
        assert got[0] == got[1], method
        frames = wire.unframe_messages(got[0])
        assert frames[-1] == (0x80, b"grpc-status:0\r\n")


def test_status_metadata_and_health(stack):
    for path in ("/v1/models/g", "/v1/models/g/metadata"):
        ours = json.loads(_get(stack["rest"], path))
        theirs = json.loads(_get(stack["jax_rest"], path))
        assert ours == theirs, path
    health = json.loads(_get(stack["rest"], "/healthz"))
    assert health["status"] == "ok"
    sat = health["saturation"]["g"]
    assert sat["sharding"] == {"num_shards": 1, "on_mesh": False}
    assert "engine" in sat and "slots" in sat["engine"]
    text = _get(stack["rest"], "/metrics").decode()
    from kubeflow_tpu.obs.metrics import parse_exposition

    assert "kft_serving_batches_total" in parse_exposition(text)


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    body = conn.getresponse().read()
    conn.close()
    return body


def test_tokens_arrive_incrementally_not_at_once(stack):
    """With engine_slice_tokens=2 and 6 tokens, the frames cannot all
    arrive in one flush."""
    conn = http.client.HTTPConnection("127.0.0.1", stack["rest"],
                                      timeout=120)
    conn.request("POST", "/v1/models/g:generate",
                 body=json.dumps({"instances": _rows(1, seed=17),
                                  "stream": True}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    arrivals, events = [], []
    while True:
        lines = []
        while True:
            line = resp.readline()
            if not line:
                break
            lines.append(line)
            if line in (b"\n", b"\r\n"):
                break
        if not lines:
            break
        arrivals.append(time.monotonic())
        got = list(jax_wire.iter_sse_events(iter(lines)))
        events.extend(got)
        if got and got[-1][0] == "done":
            break
    conn.close()
    assert len([e for e, _ in events if e == "token"]) == NEW_TOKENS
    assert arrivals[-1] - arrivals[0] > 0.0005, \
        "all frames arrived in one flush — stream was buffered"
