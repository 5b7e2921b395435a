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

"""``kft-model-server`` fronting a 2-rank gloo gang of the port.

The twin of ``tests/test_serving_sharded.py``'s ``ShardedServerEndToEnd``:
the reference writes one ``llama-test`` fp32 weight set as a
``tensor=2`` sharded export and as a monolithic one (sampled at 0.8 with
deterministic keys, so both servers mint the same keys), on its
metadata. Two processes of ``python -m kubeflow_tpu_torch.serving.server
--device cpu`` start with the launcher's gang env: rank 0 serves REST and
gRPC through its ``ModelManager``, over two models of that export (one
through the micro-batcher, one through the decode engine); rank 1 opens
no port and follows. Held: full-width and short prompts through REST
and a gRPC Predict equal the reference's monolithic ``run``; ``/healthz``
reports the topology ``{"tensor": 2, "fsdp": 1}`` on the mesh; a second
version written under the base path is swapped in and its tokens are
the reference's for that version (rank 1 holds its shard); rank 1 exits
0 once rank 0 shuts down, having loaded every version rank 0 loaded.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_gang import REPO, free_port
from _torch_serving import post
from kubeflow_tpu.models.llama import llama_test
from kubeflow_tpu.serving import sharding as sh
from kubeflow_tpu.serving import wire as jax_wire
from kubeflow_tpu.serving.export import export_model
from kubeflow_tpu.serving.model import load_version
from kubeflow_tpu.serving.signature import (
    ModelMetadata,
    Signature,
    TensorSpec,
)
from kubeflow_tpu_torch.serving import wire

PROMPT_LEN = 8
NEW_TOKENS = 6
CACHE = 32
MODELS = ("sharded", "streamed")
PROMPTS = ([[7] * PROMPT_LEN], [[11, 12, 13]])


def _metadata():
    return ModelMetadata(
        model_name="sharded", registry_name="llama-test",
        model_kwargs={"dtype": "float32", "cache_size": CACHE},
        signatures={"serving_default": Signature(
            "generate",
            {"input_ids": TensorSpec("int32", (-1, PROMPT_LEN))},
            {"tokens": TensorSpec("int32", (-1, NEW_TOKENS))})},
        generate_config={"max_new_tokens": NEW_TOKENS,
                         "temperature": 0.8, "seed": 5,
                         "deterministic": True,
                         "engine_slots": 2, "engine_page_size": 8,
                         "engine_slice_tokens": 2})


def _params(seed):
    model = llama_test(dtype=jnp.float32)
    return {"params": model.init(jax.random.PRNGKey(seed), jnp.zeros(
        (1, PROMPT_LEN), jnp.int32))["params"]}


def _get(port, path, timeout=5.0):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, None
    except OSError:
        return None, None


def _tokens(port, model, rows):
    status, raw = post(port, f"/v1/models/{model}:generate",
                       {"instances": rows})
    assert status == 200, raw
    return [p["tokens"] for p in json.loads(raw)["predictions"]]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    base = tmp_path_factory.mktemp("gang-server")
    meta = _metadata()
    bases = {name: base / name for name in MODELS}
    for path in bases.values():
        sh.export_model_sharded(str(path), 1, meta, _params(0),
                                sh.ShardSpec(tensor=2))
    export_model(str(base / "mono"), 1, meta, _params(0))
    export_model(str(base / "mono"), 2, meta, _params(1))
    config = base / "models.json"
    config.write_text(json.dumps([
        {"name": "sharded", "base_path": str(bases["sharded"]),
         "max_batch": 4},
        {"name": "streamed", "base_path": str(bases["streamed"]),
         "max_batch": 4, "continuous_batching": True}]))
    rest, grpc_port, gang_port = free_port(), free_port(), free_port()
    # Each process logs to a file (a pipe nobody reads could fill and
    # block it).
    logs = [base / f"rank{rank}.log" for rank in range(2)]
    sinks = [open(log, "w") for log in logs]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2",
                   KFT_COORDINATOR_ADDRESS=f"127.0.0.1:{gang_port}",
                   KFT_NUM_PROCESSES="2", KFT_PROCESS_ID=str(rank))
        env.pop("MEGASCALE_NUM_SLICES", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.serving.server",
             "--device", "cpu", "--model_config_file", str(config),
             "--rest_port", str(rest), "--port", str(grpc_port),
             "--poll_interval", "0.5"],
            env=env, cwd=REPO, stdout=subprocess.DEVNULL,
            stderr=sinks[rank]))
    # The reference's monolithic loads, while the gang loads.
    want = {}
    for version in (1, 2):
        mono = load_version(str(base / "mono" / str(version)), max_batch=4)
        want[version] = [mono.run({"input_ids": np.asarray(p)})["tokens"]
                         for p in PROMPTS]
        mono.close()
    deadline = time.monotonic() + 240
    while _get(rest, "/healthz")[0] != 200:
        assert all(p.poll() is None for p in procs), [
            log.read_text()[-3000:] for log in logs]
        assert time.monotonic() < deadline, "the gang never became ready"
        time.sleep(0.2)
    yield {"rest": rest, "grpc": grpc_port, "procs": procs, "want": want,
           "bases": bases, "logs": logs}
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for sink in sinks:
        sink.close()


@pytest.mark.parametrize("model", MODELS)
def test_rest_generate_equals_the_monolithic_load(served, model):
    for prompt, want in zip(PROMPTS, served["want"][1]):
        np.testing.assert_array_equal(
            np.asarray(_tokens(served["rest"], model, prompt)), want)


def test_grpc_predict_equals_the_monolithic_load(served):
    import grpc

    prompt = np.asarray(PROMPTS[0], np.int32)
    request = wire.encode_predict_request("sharded",
                                          {"input_ids": prompt})
    with grpc.insecure_channel(f"127.0.0.1:{served['grpc']}") as channel:
        reply = channel.unary_unary(
            "/tensorflow.serving.PredictionService/Predict"
        )(request, timeout=60.0)
    _, outputs = jax_wire.decode_predict_response(reply)
    np.testing.assert_array_equal(outputs["tokens"], served["want"][1][0])


def test_healthz_reports_the_gang_topology(served):
    status, payload = _get(served["rest"], "/healthz")
    assert status == 200
    for model in MODELS:
        topo = payload["saturation"][model]["sharding"]
        assert topo == {"num_shards": 2, "mesh": {"tensor": 2, "fsdp": 1},
                        "on_mesh": True}
    assert payload["role"] == "any"


def test_a_swap_reaches_rank_1_and_rank_1_exits_with_rank_0(served):
    sh.export_model_sharded(str(served["bases"]["sharded"]), 2,
                            _metadata(), _params(1), sh.ShardSpec(tensor=2))
    deadline = time.monotonic() + 120
    while _get(served["rest"], "/v1/models/sharded/metadata")[1][
            "model_spec"]["version"] != "2":
        assert time.monotonic() < deadline, "version 2 never swapped in"
        time.sleep(0.2)
    for prompt, want in zip(PROMPTS, served["want"][2]):
        np.testing.assert_array_equal(
            np.asarray(_tokens(served["rest"], "sharded", prompt)), want)
    served["procs"][0].send_signal(signal.SIGTERM)
    codes = [p.wait(timeout=60) for p in served["procs"]]
    logs = [log.read_text() for log in served["logs"]]
    assert codes == [0, 0], [log[-3000:] for log in logs]
    assert "rank 0 stopped; loaded [('sharded', 1), ('streamed', 1), " \
           "('sharded', 2)]" in logs[1], logs[1][-3000:]
