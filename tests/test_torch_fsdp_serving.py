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

"""The fsdp-sharded serving forward on a 4-rank gloo gang of the port.

The twin of ``tests/test_generate.py``'s
``test_sharded_generation_matches_unsharded``: the reference's
``llama-test`` fp32 params (seed 1) and its prompt (``randint(PRNGKey(21),
(2, 6), 0, 512)``), greedy, 8 new tokens, written as an ``fsdp=2,
tensor=2`` export and an ``fsdp=4`` export (the twin's mesh without its
``data=2``, which the reference's serving manifest does not have). The
gang loads each onto its serving mesh, rank r reading shard file r
alone; each rank holds 1/(F·T) of every kernel and the token table at
rest and gathers a leaf's fsdp piece just before its op. Held: the
files each rank opened and the shapes it holds; the ``fsdp=2,
tensor=2`` logits bitwise those of the same ranks' tensor-only forward
(the ``tensor=2`` model, params whole over fsdp), the ``fsdp=4`` logits
bitwise the one-process load's, both within ``LOGIT_TOL`` of the
reference's forward; greedy tokens through ``run`` equal to the
reference's one-device ``generate`` on every rank.
"""

import concurrent.futures

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from _torch_gang import run_gang
from kubeflow_tpu.inference.generate import generate
from kubeflow_tpu.models.llama import llama_test
from kubeflow_tpu.serving import sharding as sh
from kubeflow_tpu.serving.signature import (
    ModelMetadata,
    Signature,
    TensorSpec,
)
from kubeflow_tpu_torch.models.llama import apply
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.serving.model import load_version

PROMPT_LEN = 6
NEW_TOKENS = 8
CACHE = 16
LOGIT_TOL = 1e-5
MESHES = {"fsdp2_tensor2": sh.ShardSpec(tensor=2, fsdp=2),
          "fsdp4": sh.ShardSpec(fsdp=4)}


def _metadata():
    return ModelMetadata(
        model_name="fsdp", registry_name="llama-test",
        model_kwargs={"dtype": "float32", "cache_size": CACHE},
        signatures={"serving_default": Signature(
            "generate",
            {"input_ids": TensorSpec("int32", (-1, PROMPT_LEN))},
            {"tokens": TensorSpec("int32", (-1, NEW_TOKENS))})},
        generate_config={"max_new_tokens": NEW_TOKENS, "temperature": 0.0})


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    base = tmp_path_factory.mktemp("fsdp-serving")
    prompt = jax.random.randint(jax.random.PRNGKey(21), (2, PROMPT_LEN), 0,
                                512)
    plain = llama_test(dtype=jnp.float32)
    boxed = plain.init(jax.random.PRNGKey(1), prompt)
    params = nn.meta.unbox(boxed["params"])
    paths = {}
    for name, spec in MESHES.items():
        sh.export_model_sharded(str(base / name), 1, _metadata(),
                                {"params": boxed["params"]}, spec)
        paths[name] = str(base / name / "1")
    ids = np.random.default_rng(4).integers(0, 512, (2, 12)).astype(
        np.int32)
    flat = {k: np.asarray(v) for k, v in
            flatten_dict(params, sep="/").items()}
    case = {"name": "fsdp", "exports": paths, "ids": ids,
            "prompt": np.asarray(prompt, np.int32), "flat": flat}
    # The gang runs (in a thread: it waits on its processes) while this
    # process runs the reference's one-device generate and forward.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_gang, "fsdp", [case], base / "gang",
                            world=4, timeout=300.0)
        tokens, _ = generate(llama_test(dtype=jnp.float32,
                                        cache_size=CACHE),
                             params, prompt, max_new_tokens=NEW_TOKENS,
                             temperature=0.0)
        want = np.asarray(plain.apply({"params": params},
                                      jnp.asarray(ids)))
        ranks = ranks.result()
    return {"ranks": [r["fsdp"] for r in ranks], "paths": paths,
            "tokens": np.asarray(tokens), "logits": want, "ids": ids,
            "flat": flat}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_each_rank_reads_its_shard_and_holds_its_piece(gang, name):
    spec = MESHES[name]
    whole = get_model("llama-test").make(dtype="float32")
    full = {k: tuple(p.shape) for k, p in whole.named_parameters()}
    for r, res in enumerate(gang["ranks"]):
        got = res[name]
        assert got["opened"] == [f"params.shard-0000{r}-of-00004.msgpack"]
        assert got["topology"] == {"num_shards": 4, "mesh": spec.to_json(),
                                   "on_mesh": True}
        for key, shape in full.items():
            held = got["shapes"][key]
            parts = 1 if "norm" in key else spec.fsdp * spec.tensor
            assert int(np.prod(held)) * parts == int(np.prod(shape)), key


def test_fsdp_tensor_logits_are_the_tensor_gangs_bitwise(gang):
    for res in gang["ranks"]:
        got = res["fsdp2_tensor2"]
        np.testing.assert_array_equal(got["logits"], got["tensor_logits"])
        np.testing.assert_allclose(got["logits"], gang["logits"], rtol=0,
                                   atol=LOGIT_TOL)


def test_fsdp_logits_are_the_one_process_loads_bitwise(gang):
    one = load_version(gang["paths"]["fsdp4"], device="cpu")
    model = get_model("llama-test").make(dtype="float32")
    with torch.no_grad():
        want = apply(model, one.params,
                     torch.from_numpy(gang["ids"])).numpy()
    np.testing.assert_allclose(want, gang["logits"], rtol=0, atol=LOGIT_TOL)
    for res in gang["ranks"]:
        np.testing.assert_array_equal(res["fsdp4"]["logits"], want)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_greedy_tokens_equal_the_reference_one_device(gang, name):
    lead = gang["ranks"][0][name]
    np.testing.assert_array_equal(lead["tokens"], gang["tokens"])
    for follower in gang["ranks"][1:]:
        (run,) = follower[name]["runs"]
        np.testing.assert_array_equal(run["tokens"], gang["tokens"])
