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

"""The port's sharded export writer against the reference's.

One ``llama-test`` weight set (fp32 and a bf16 cast), exported by the
reference monolithic and sharded. The port reads the monolithic export
(the tree, boxes and all, as its server reads it) and writes it sharded
with the same spec: ``signature.json`` and every shard file byte-equal
to the reference's, no ``params.msgpack``; its plan is the reference's
``build_shard_plan`` of the same tree. ``n = 1`` writes the monolithic
layout, byte-equal to the reference's. Then the twin of
``tests/test_serving_sharded.py::test_export_cli_shards_flag``:
``kft-export --shards tensor=2`` writes a two-shard export that the
port's server loads and serves with the monolithic export's tokens.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.models.llama import llama_test
from kubeflow_tpu.serving import sharding as jax_sh
from kubeflow_tpu.serving.export import export_model as jax_export_model
from kubeflow_tpu.serving.signature import ModelMetadata as JaxMetadata
from kubeflow_tpu.utils.trees import cast_floating
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.serving import sharding as sh
from kubeflow_tpu_torch.serving.export import (
    PARAMS_FILE,
    read_metadata,
    read_variables,
)
from kubeflow_tpu_torch.serving.export_cli import (
    export_from_checkpoint,
    main,
)
from kubeflow_tpu_torch.serving.model import load_version

PROMPT_LEN = 8
NEW_TOKENS = 6
SPECS = {"tensor2": dict(tensor=2), "fsdp2": dict(fsdp=2),
         "tensor2_fsdp2": dict(tensor=2, fsdp=2), "tensor4": dict(tensor=4)}


def _metadata() -> JaxMetadata:
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
                            "temperature": 0.0}})


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    base = tmp_path_factory.mktemp("exports")
    model = llama_test(dtype=jnp.float32)
    variables = jax.jit(functools.partial(model.init))(
        jax.random.PRNGKey(0), jnp.zeros((1, PROMPT_LEN), jnp.int32))
    boxed = {"f32": variables["params"],
             "bf16": cast_floating(variables["params"], jnp.bfloat16)}
    meta = _metadata()
    for dtype, params in boxed.items():
        jax_export_model(str(base / dtype / "mono"), 1, meta,
                         {"params": params})
        for name, spec in SPECS.items():
            jax_sh.export_model_sharded(str(base / dtype / name), 1, meta,
                                        {"params": params},
                                        jax_sh.ShardSpec(**spec))
        jax_sh.export_model_sharded(str(base / dtype / "n1"), 1, meta,
                                    {"params": params}, jax_sh.ShardSpec())
    return base, boxed


def _files(version_dir):
    return {f: open(os.path.join(version_dir, f), "rb").read()
            for f in sorted(os.listdir(version_dir))}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_shard_files_are_the_references_bytes(exports, tmp_path, spec,
                                              dtype):
    base, boxed = exports
    mono = str(base / dtype / "mono" / "1")
    variables = read_variables(mono)
    module = get_model("llama-test").make(dtype="float32")
    plan = sh.build_shard_plan(variables, sh.ShardSpec(**SPECS[spec]),
                               module)
    assert plan == jax_sh.build_shard_plan({"params": boxed[dtype]},
                                           jax_sh.ShardSpec(**SPECS[spec]))
    path = sh.export_model_sharded(str(tmp_path / "port"), 1,
                                   read_metadata(mono), variables,
                                   sh.ShardSpec(**SPECS[spec]), module)
    want = _files(str(base / dtype / spec / "1"))
    got = _files(str(path))
    assert PARAMS_FILE not in got
    assert list(got) == list(want)
    for name, data in want.items():
        assert got[name] == data, name
    assert not [p for p in os.listdir(tmp_path / "port")
                if p.startswith(".tmp")]
    with pytest.raises(FileExistsError):
        sh.export_model_sharded(str(tmp_path / "port"), 1,
                                read_metadata(mono), variables,
                                sh.ShardSpec(**SPECS[spec]), module)


def test_one_shard_writes_the_monolithic_layout(exports, tmp_path):
    base, _ = exports
    mono = str(base / "f32" / "mono" / "1")
    path = sh.export_model_sharded(str(tmp_path / "n1"), 1,
                                   read_metadata(mono), read_variables(mono),
                                   sh.ShardSpec())
    assert _files(str(path)) == _files(str(base / "f32" / "n1" / "1"))
    assert read_metadata(str(path)).sharding is None
    with pytest.raises(ValueError, match="logical axes"):
        sh.export_model_sharded(str(tmp_path / "x"), 1, read_metadata(mono),
                                read_variables(mono), sh.ShardSpec(tensor=2))


def test_export_cli_shards_flag(tmp_path):
    """Twin of tests/test_serving_sharded.py::test_export_cli_shards_flag:
    kft-export writes the two-shard layout, and the port's server
    serves it with the monolithic export's tokens (the same seed's
    weights)."""
    kw = dict(registry_name="llama-test", version=1, seq_len=PROMPT_LEN,
              generate_config={"max_new_tokens": NEW_TOKENS},
              model_kwargs={"dtype": "float32"}, device="cpu")
    path = export_from_checkpoint(out=str(tmp_path / "cli"),
                                  shard_spec=sh.parse_shard_spec("tensor=2"),
                                  **kw)
    meta = read_metadata(path)
    assert meta.sharding["num_shards"] == 2
    assert not os.path.exists(os.path.join(path, PARAMS_FILE))
    mono = export_from_checkpoint(out=str(tmp_path / "mono"), **kw)
    prompt = np.random.default_rng(3).integers(0, 512, (2, PROMPT_LEN))
    loaded = load_version(path, max_batch=4, device="cpu")
    assert loaded.shard_topology() == {
        "num_shards": 2, "mesh": {"tensor": 2, "fsdp": 1}, "on_mesh": False}
    np.testing.assert_array_equal(
        loaded.run({"input_ids": prompt})["tokens"],
        load_version(mono, max_batch=4, device="cpu").run(
            {"input_ids": prompt})["tokens"])
    assert main(["--model", "llama-test", "--out", str(tmp_path / "c"),
                 "--shards", "2", "--seq_len", str(PROMPT_LEN),
                 "--model_kwargs", '{"dtype": "float32"}',
                 "--device", "cpu"]) == 0
    assert read_metadata(str(tmp_path / "c" / "1")).sharding[
        "mesh"] == {"tensor": 2, "fsdp": 1}
