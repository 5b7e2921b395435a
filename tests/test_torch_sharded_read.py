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

"""kubeflow_tpu_torch.serving.sharding's read half against the reference.

The reference writes one ``llama-test`` weight set monolithic and
sharded (``export_model_sharded`` over tensor, fsdp and both, fp32 and a
bf16 cast), as tests/test_serving_sharded.py's ``exports`` fixture does
on the CPU devices tests/conftest.py forces. The port's
``read_sharded_variables`` gives the monolithic variables back bit for
bit; its ``load_version`` serves the sharded export with the reference's
greedy and sampled tokens; ``shard_topology`` and ``parse_shard_spec``
answer the reference's cases as the reference does; and a manifest the
port cannot read raises, as the reference's does.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from kubeflow_tpu.models.llama import llama_test
from kubeflow_tpu.serving import sharding as jax_sh
from kubeflow_tpu.serving.export import export_model as jax_export_model
from kubeflow_tpu.serving.model import load_version as jax_load_version
from kubeflow_tpu.serving.signature import ModelMetadata as JaxMetadata
from kubeflow_tpu.utils.trees import cast_floating
from kubeflow_tpu_torch.models.convert import flatten_tree
from kubeflow_tpu_torch.serving import sharding as sh
from kubeflow_tpu_torch.serving.export import (
    read_metadata,
    read_variables,
    unbox,
)
from kubeflow_tpu_torch.serving.model import load_version

PROMPT_LEN = 8
NEW_TOKENS = 6
SPECS = {"tensor2": dict(tensor=2), "fsdp2": dict(fsdp=2),
         "tensor2_fsdp2": dict(tensor=2, fsdp=2)}


def _metadata(temperature: float) -> JaxMetadata:
    return JaxMetadata.from_json({
        "model_name": "sharded", "registry_name": "llama-test",
        "model_kwargs": {"dtype": "float32",
                         "cache_size": PROMPT_LEN + NEW_TOKENS + 2},
        "signatures": {"serving_default": {
            "method": "generate",
            "inputs": {"input_ids": {"dtype": "int32",
                                     "shape": [-1, PROMPT_LEN]}},
            "outputs": {"tokens": {"dtype": "int32",
                                   "shape": [-1, NEW_TOKENS]}}}},
        "generate_config": {"max_new_tokens": NEW_TOKENS,
                            "temperature": temperature, "seed": 5,
                            "deterministic": True}})


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """One weight set in every layout: monolithic and each shard spec,
    greedy and sampled, fp32 and a bf16 cast of the same params."""
    base = tmp_path_factory.mktemp("sharded")
    model = llama_test(dtype=jnp.float32)
    init = jax.jit(functools.partial(model.init))
    params = init(jax.random.PRNGKey(0),
                  jnp.zeros((1, PROMPT_LEN), jnp.int32))["params"]
    weights = {"f32": params, "bf16": cast_floating(params, jnp.bfloat16)}
    for mode, temperature in (("greedy", 0.0), ("sampled", 0.8)):
        meta = _metadata(temperature)
        for dtype, p in weights.items():
            jax_export_model(str(base / mode / dtype / "mono"), 1, meta,
                             {"params": p})
            for name, spec in SPECS.items():
                jax_sh.export_model_sharded(
                    str(base / mode / dtype / name), 1, meta,
                    {"params": p}, jax_sh.ShardSpec(**spec))
    return base


def _leaves(tree):
    return {k: (v.float().numpy() if isinstance(v, torch.Tensor)
                and v.dtype == torch.bfloat16 else np.asarray(v),
                str(v.dtype))
            for k, v in flatten_tree(unbox(tree)).items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_read_sharded_variables_is_the_monolithic_tree(exports, spec, dtype):
    root = exports / "greedy" / dtype
    mono = read_variables(str(root / "mono" / "1"))
    version = str(root / spec / "1")
    meta = read_metadata(version)
    assert meta.sharding["num_shards"] == sh.ShardSpec(
        **SPECS[spec]).num_shards
    axes = {entry["axis"] for entry in meta.sharding["plan"].values()}
    assert axes == set(SPECS[spec]), axes  # every axis splits leaves
    back = sh.read_sharded_variables(version, None, meta)
    want, got = _leaves(mono), _leaves(back)
    assert set(got) == set(want)
    for key, (value, kind) in want.items():
        assert got[key][1] == kind, key
        np.testing.assert_array_equal(got[key][0], value, err_msg=key)
    # Held against a template of the monolithic tree's shapes.
    template = {"params": unbox(mono["params"]), "cache": {}}
    assert set(sh.read_sharded_variables(version, template, meta)) == {
        "params"}


def test_the_template_is_checked(exports):
    version = str(exports / "greedy" / "f32" / "tensor2" / "1")
    meta = read_metadata(version)
    params = unbox(read_variables(
        str(exports / "greedy" / "f32" / "mono" / "1"))["params"])
    with pytest.raises(ValueError, match="lacks collections"):
        sh.read_sharded_variables(version, {"params": params,
                                            "batch_stats": {}}, meta)
    wrong = dict(params, final_norm={"scale": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="final_norm/scale"):
        sh.read_sharded_variables(version, {"params": wrong}, meta)
    extra = dict(params, spare={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="spare/w"):
        sh.read_sharded_variables(version, {"params": extra}, meta)


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_load_version_serves_a_sharded_export_with_the_references_tokens(
        exports, spec, mode):
    root = exports / mode / "f32"
    prompt = np.asarray(jax.random.randint(
        jax.random.PRNGKey(3), (2, PROMPT_LEN), 0, 512))
    want = np.asarray(jax_load_version(str(root / "mono" / "1"),
                                       max_batch=4).run(
        {"input_ids": prompt})["tokens"])
    loaded = load_version(str(root / spec / "1"), max_batch=4, device="cpu")
    np.testing.assert_array_equal(loaded.run({"input_ids": prompt})["tokens"],
                                  want)
    topo = loaded.shard_topology()
    assert topo == {"num_shards": sh.ShardSpec(**SPECS[spec]).num_shards,
                    "mesh": {"tensor": 1, "fsdp": 1, **SPECS[spec]},
                    "on_mesh": False}


def test_unreadable_manifests_raise_as_the_references(exports):
    version = str(exports / "greedy" / "f32" / "tensor2" / "1")
    meta = read_metadata(version)
    jax_meta = jax_sh.ModelMetadata.loads(meta.dumps())
    for sharding, match in (
            ({**meta.sharding, "format": 99}, "format 99"),
            ({**meta.sharding, "shards": meta.sharding["shards"][:1]},
             "lists 1 shard files")):
        with pytest.raises(ValueError, match=match):
            sh.read_sharded_variables(
                version, None, dataclasses.replace(meta, sharding=sharding))
        with pytest.raises(ValueError, match=match):
            jax_sh._manifest_of(dataclasses.replace(jax_meta,
                                                    sharding=sharding))
    with pytest.raises(ValueError, match="no shard manifest"):
        sh.read_sharded_variables(
            version, None, dataclasses.replace(meta, sharding=None))


def test_a_leaf_outside_the_plan_in_a_later_shard_raises(tmp_path, exports):
    import shutil

    src = exports / "greedy" / "f32" / "tensor2" / "1"
    bad = tmp_path / "bad" / "1"
    shutil.copytree(src, bad)
    meta = read_metadata(str(bad))
    second = bad / meta.sharding["shards"][1]
    flat = serialization.msgpack_restore(second.read_bytes())
    flat["params/stray"] = np.zeros(2, np.float32)
    second.write_bytes(serialization.msgpack_serialize(flat))
    with pytest.raises(ValueError, match="unplanned leaf"):
        sh.read_sharded_variables(str(bad), None, meta)


def test_shard_topology_matches_the_reference(exports):
    meta = read_metadata(str(exports / "greedy" / "f32" / "tensor2" / "1"))
    mono = read_metadata(str(exports / "greedy" / "f32" / "mono" / "1"))
    for m in (meta, mono,
              dataclasses.replace(meta, sharding={"num_shards": "lots",
                                                  "mesh": None}),
              dataclasses.replace(meta, sharding={"num_shards": 4,
                                                  "mesh": {"tensor": 4}})):
        want = jax_sh.shard_topology(jax_sh.ModelMetadata.loads(m.dumps()))
        assert sh.shard_topology(m) == want
    assert sh.shard_topology(dataclasses.replace(
        meta, sharding={"num_shards": "lots", "mesh": None})) == {
        "num_shards": 1, "malformed": True}


@pytest.mark.parametrize("raw", [None, "", "2", " 4 ", "tensor=2,fsdp=2",
                                 "fsdp=2", "tensor=3"])
def test_parse_shard_spec_matches_the_reference(raw):
    got, want = sh.parse_shard_spec(raw), jax_sh.parse_shard_spec(raw)
    assert got.to_json() == want.to_json()
    assert got.num_shards == want.num_shards
    assert sh.ShardSpec.from_json(want.to_json()) == got


@pytest.mark.parametrize("raw", ["bogus=3", "tensor", "tensor=0"])
def test_parse_shard_spec_refuses_what_the_reference_refuses(raw):
    with pytest.raises(ValueError):
        jax_sh.parse_shard_spec(raw)
    with pytest.raises(ValueError):
        sh.parse_shard_spec(raw)


def test_manifest_dumps_like_the_references(exports):
    meta = read_metadata(str(exports / "greedy" / "f32" / "tensor2_fsdp2"
                             / "1"))
    assert sh.dumps_manifest(meta.sharding) == jax_sh.dumps_manifest(
        meta.sharding)
    assert json.loads(sh.dumps_manifest(meta.sharding)) == meta.sharding
    assert sh.MANIFEST_FORMAT == jax_sh.MANIFEST_FORMAT
    assert sh.SHARD_FILE_FMT == jax_sh.SHARD_FILE_FMT
