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

"""A ``tensor=2`` export served on a 2-rank gloo gang of the port,
against the reference's mesh load and monolithic load.

The reference writes one ``llama-test`` fp32 weight set twice, as a
``tensor=2`` sharded export and a monolithic one, once greedy and once
sampled (temperature 0.8, deterministic keys), as
``tests/test_serving_sharded.py`` does. The gang's ``load_version``
places each sharded export onto its serving mesh, rank r reading shard
r alone (the leaves the plan keeps whole reach rank 1 by rank 0's
broadcast); rank 0 drives ``run`` and the engine while rank 1 runs
``follow()``. Held: the topology, the files each rank opened, the
forward's logits within ``LOGIT_TOL`` (1e-5) of the reference's forward,
greedy and sampled tokens through ``run`` and through the engine equal
to the reference's mesh and monolithic loads (the reference pins those
two equal), rank 1's tokens equal to rank 0's for every request, and
each engine stream equal to the gang's own B = 1 ``run`` with its key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_gang import run_gang
from kubeflow_tpu.models.llama import llama_test
from kubeflow_tpu.serving import sharding as sh
from kubeflow_tpu.serving.export import export_model
from kubeflow_tpu.serving.model import load_version
from kubeflow_tpu.serving.signature import (
    ModelMetadata,
    Signature,
    TensorSpec,
)

PROMPT_LEN = 8
NEW_TOKENS = 6
CACHE = 32
LOGIT_TOL = 1e-5
TEMPERATURES = {"greedy": 0.0, "sampled": 0.8}


def _metadata(temperature):
    return ModelMetadata(
        model_name="sharded", registry_name="llama-test",
        model_kwargs={"dtype": "float32", "cache_size": CACHE},
        signatures={"serving_default": Signature(
            "generate",
            {"input_ids": TensorSpec("int32", (-1, PROMPT_LEN))},
            {"tokens": TensorSpec("int32", (-1, NEW_TOKENS))})},
        generate_config={"max_new_tokens": NEW_TOKENS,
                         "temperature": temperature, "seed": 5,
                         "deterministic": True,
                         "engine_slots": 2, "engine_page_size": 8,
                         "engine_slice_tokens": 2})


def _prompts():
    rng = np.random.default_rng(3)
    run = rng.integers(0, 512, (2, PROMPT_LEN)).astype(np.int32)
    engine = [rng.integers(0, 512, (n,)).astype(np.int32)
              for n in (8, 5, 8, 3)]
    keys = [np.asarray(jax.random.PRNGKey(100 + i), np.uint32)
            for i in range(len(engine))]
    return run, engine, keys


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    base = tmp_path_factory.mktemp("tensor-serving")
    model = llama_test(dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, PROMPT_LEN), jnp.int32))
    params = {"params": variables["params"]}
    paths = {}
    for name, temp in TEMPERATURES.items():
        meta = _metadata(temp)
        export_model(str(base / f"mono-{name}"), 1, meta, params)
        sh.export_model_sharded(str(base / f"sharded-{name}"), 1, meta,
                                params, sh.ShardSpec(tensor=2))
        paths[name] = {"mono": str(base / f"mono-{name}" / "1"),
                       "sharded": str(base / f"sharded-{name}" / "1")}
    run_prompts, engine_prompts, keys = _prompts()
    ids = np.random.default_rng(4).integers(0, 512, (2, 12)).astype(
        np.int32)
    case = {"name": "serve",
            "exports": {n: p["sharded"] for n, p in paths.items()},
            "ids": ids, "run_prompts": run_prompts,
            "engine_prompts": engine_prompts, "keys": keys}
    ranks = run_gang("serve", [case], base / "gang", world=2)
    return variables, paths, case, [r["serve"] for r in ranks]


def test_each_rank_loads_its_own_shard_onto_the_mesh(served):
    _, paths, _, ranks = served
    for name in TEMPERATURES:
        for r, res in enumerate(ranks):
            got = res[name]
            assert got["opened"] == [
                f"params.shard-0000{r}-of-00002.msgpack"]
            assert got["topology"] == {"num_shards": 2,
                                       "mesh": {"tensor": 2, "fsdp": 1},
                                       "on_mesh": True}


def test_gang_forward_matches_the_references(served):
    variables, _, case, ranks = served
    want = np.asarray(llama_test(dtype=jnp.float32).apply(
        {"params": variables["params"]}, jnp.asarray(case["ids"])))
    for res in ranks:
        for name in TEMPERATURES:
            np.testing.assert_allclose(res[name]["logits"], want, rtol=0,
                                       atol=LOGIT_TOL)


@pytest.mark.parametrize("name", sorted(TEMPERATURES))
def test_gang_tokens_equal_the_reference_mesh_and_monolithic_loads(
        served, name):
    _, paths, case, ranks = served
    lead = ranks[0][name]
    for layout in ("sharded", "mono"):
        ref = load_version(paths[name][layout], max_batch=4)
        if layout == "sharded":
            assert ref.mesh is not None and ref.mesh.shape["tensor"] == 2
        np.testing.assert_array_equal(
            lead["run"], ref.run({"input_ids": case["run_prompts"]})[
                "tokens"], err_msg=layout)
        engine = ref.ensure_engine()
        streams = [engine.submit(p, rng=k) for p, k in
                   zip(case["engine_prompts"], case["keys"])]
        for i, s in enumerate(streams):
            np.testing.assert_array_equal(lead["streams"][i],
                                          s.result(120.0),
                                          err_msg=f"{layout} request {i}")
        ref.close()


@pytest.mark.parametrize("name", sorted(TEMPERATURES))
def test_gang_ranks_agree_and_engine_equals_b1(served, name):
    _, _, case, ranks = served
    lead, follower = ranks[0][name], ranks[1][name]
    assert lead["stats"]["gang"] == {"ranks": 2, "capture_graphs": False}
    assert follower["engine"] == lead["engine"]
    assert len(lead["engine"]) == len(case["engine_prompts"])
    assert len(follower["runs"]) == 1 + len(case["engine_prompts"])
    np.testing.assert_array_equal(follower["runs"][0]["tokens"],
                                  lead["run"])
    for i, b1 in enumerate(lead["b1"]):
        np.testing.assert_array_equal(follower["runs"][1 + i]["tokens"][0],
                                      b1)
        np.testing.assert_array_equal(lead["streams"][i], b1,
                                      err_msg=f"request {i}")
        assert lead["engine"][i] == list(lead["streams"][i])
