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

"""Export directories across the two packages.

- The reference's ``export_model`` of ``llama-test`` (params with their
  partitioning boxes, as its exporter writes them) loads through the
  port's ``load_version``: predict logits within 1e-4 of the
  reference's ``load_version``, greedy and sampled tokens equal.
- The port's ``export_model`` reads back through Flax's
  ``msgpack_restore`` to the same arrays, and its bytes are Flax's.
- Flax's chunked arrays, with ``MAX_CHUNK_SIZE`` monkeypatched small in
  both writers, cross both ways.
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from flax.traverse_util import flatten_dict

from kubeflow_tpu.models.llama import llama_test as jax_llama_test
from kubeflow_tpu.serving.export import export_model as jax_export_model
from kubeflow_tpu.serving.model import load_version as jax_load_version
from kubeflow_tpu.serving.signature import ModelMetadata as JaxMetadata
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.serving import flax_msgpack
from kubeflow_tpu_torch.serving.export import (
    export_model,
    read_metadata,
    read_variables,
    unbox,
)
from kubeflow_tpu_torch.serving.model import load_version
from kubeflow_tpu_torch.serving.signature import (
    ModelMetadata,
    Signature,
    TensorSpec,
)

SEQ = 16
NEW = 5


def _metadata(method, generate_config=None, **kwargs):
    out = ({"tokens": TensorSpec("int32", (-1, NEW))}
           if method == "generate" else {})
    return ModelMetadata(
        model_name="tiny", registry_name="llama-test",
        model_kwargs={"dtype": "float32", **kwargs},
        signatures={"serving_default": Signature(
            method=method,
            inputs={"input_ids": TensorSpec("int32", (-1, SEQ))},
            outputs=out)},
        generate_config=generate_config or {})


@pytest.fixture(scope="module")
def boxed_variables():
    """What the reference's exporter writes: ``model.init``'s variables
    with their ``nn.Partitioned`` boxes kept."""
    return jax_llama_test(dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))


def _jax_export(tmp_path, meta, variables, version=1):
    jax_export_model(str(tmp_path), version, JaxMetadata.loads(meta.dumps()),
                     {"params": variables["params"]})
    return os.path.join(str(tmp_path), str(version))


def test_jax_export_loads_to_the_reference_logits(tmp_path, boxed_variables):
    meta = _metadata("predict")
    path = _jax_export(tmp_path, meta, boxed_variables)
    ours = load_version(path, max_batch=2, device="cpu")
    ref = jax_load_version(path, max_batch=2)
    assert ours.version == 1 and ours.metadata == read_metadata(path)
    x = np.random.default_rng(0).integers(0, 512, (3, SEQ)).astype(np.int32)
    np.testing.assert_allclose(
        ours.run({"input_ids": x})["logits"],
        np.asarray(ref.run({"input_ids": x})["logits"]), atol=1e-4,
        rtol=1e-4)


@pytest.mark.parametrize("sampling", [
    {"temperature": 0.0},
    {"temperature": 0.8, "top_k": 50, "top_p": 0.95, "deterministic": True}],
    ids=["greedy", "sampled"])
def test_jax_export_generates_the_reference_tokens(tmp_path, boxed_variables,
                                                   sampling):
    meta = _metadata("generate", dict(max_new_tokens=NEW, **sampling),
                     cache_size=SEQ + NEW)
    path = _jax_export(tmp_path, meta, boxed_variables)
    ours = load_version(path, max_batch=2, device="cpu")
    ref = jax_load_version(path, max_batch=2)
    x = np.random.default_rng(1).integers(1, 512, (2, 10)).astype(np.int32)
    lengths = np.asarray([6, 10], np.int32)
    np.testing.assert_array_equal(
        ours.run({"input_ids": x}, prompt_lengths=lengths)["tokens"],
        np.asarray(ref.run({"input_ids": x},
                           prompt_lengths=lengths)["tokens"]))


def test_port_export_restores_in_flax(tmp_path, boxed_variables):
    flat = {k: np.asarray(v) for k, v in flatten_dict(
        flax.linen.meta.unbox(boxed_variables["params"]), sep="/").items()}
    template = get_model("llama-test").make(dtype="float32")
    params = convert.params_from_flax(flat, template, device="cpu")
    assert convert.params_to_flax(params).keys() == flat.keys()
    for k, v in convert.params_to_flax(params).items():
        np.testing.assert_array_equal(v, flat[k])
    meta = _metadata("predict")
    path = export_model(str(tmp_path), 3, meta, {"params": (
        convert.unflatten_tree(convert.params_to_flax(params)))})
    data = (path / "params.msgpack").read_bytes()
    restored = flatten_dict(serialization.msgpack_restore(data)["params"],
                            sep="/")
    assert restored.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(restored[k], flat[k])
    # Byte for byte what Flax writes for the same tree.
    tree = {"params": convert.unflatten_tree(convert.params_to_flax(params))}
    assert data == serialization.to_bytes(tree)
    with pytest.raises(FileExistsError):
        export_model(str(tmp_path), 3, meta, {"params": {}})
    # And back through the port's reader to the same logits.
    again = load_version(str(path), max_batch=2, device="cpu")
    for k, v in params.items():
        assert torch.equal(again.params[k], v)


def test_codec_writes_and_reads_what_flax_does():
    tree = {"params": {
        "a": {"kernel": np.arange(12, dtype=np.float32).reshape(3, 4)},
        "scalar": np.int32(5), "empty": np.zeros((0, 3), np.float16),
        "big": np.random.default_rng(0).random(70000).astype(np.float32),
        "f64": np.linspace(0, 1, 7), "u8": np.arange(300) % 256,
        "s": "x" * 40, "ints": [1, -3, 300, -200, 70000, -70000, 2**40,
                                -2**40, 2**63],
        "f": 1.5, "t": True, "n": None, "c": 1 + 2j,
        "bf16": np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3)),
        "b": b"\x00\x01"}}
    # msgpack_serialize walks the tree with jax.tree.map, which sorts
    # dict keys; the codec keeps the order it is given.
    tree = {"params": dict(sorted(tree["params"].items()))}
    data = serialization.msgpack_serialize(tree)
    assert flax_msgpack.dumps(tree) == data
    back = flax_msgpack.loads(data)
    assert back["params"]["ints"] == tree["params"]["ints"]
    assert back["params"]["c"] == 1 + 2j and back["params"]["n"] is None
    assert isinstance(back["params"]["scalar"], np.int32)
    np.testing.assert_array_equal(back["params"]["big"],
                                  tree["params"]["big"])
    bf16 = back["params"]["bf16"]
    assert bf16.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16.float().numpy(), np.arange(
        6, dtype=np.float32).reshape(2, 3))
    assert flax_msgpack.dumps(back) == data
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.loads(data + b"\xc0")
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.loads(data[:-3])


def test_chunked_arrays_cross_both_ways(tmp_path, monkeypatch,
                                        boxed_variables):
    # The 512 x 64 fp32 embedding (128 KiB) and every bigger leaf chunk.
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 40_000)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 40_000)
    meta = _metadata("predict")
    path = _jax_export(tmp_path, meta, boxed_variables)
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        data = f.read()
    assert b"__msgpack_chunked_array__" in data
    raw = flax_msgpack.loads(data)  # the reader reassembles the chunks
    emb = unbox(raw["params"])["tok_embed"]["embedding"]
    want = np.asarray(flax.linen.meta.unbox(
        boxed_variables["params"])["tok_embed"]["embedding"])
    np.testing.assert_array_equal(emb, want)
    ours = load_version(path, max_batch=2, device="cpu")
    ref = jax_load_version(path, max_batch=2)
    x = np.random.default_rng(2).integers(0, 512, (2, SEQ)).astype(np.int32)
    np.testing.assert_allclose(
        ours.run({"input_ids": x})["logits"],
        np.asarray(ref.run({"input_ids": x})["logits"]), atol=1e-4,
        rtol=1e-4)
    # The port writes the chunked form Flax reads.
    port_path = export_model(str(tmp_path), 2, meta, {"params": (
        convert.unflatten_tree(convert.params_to_flax(ours.params)))})
    data = (port_path / "params.msgpack").read_bytes()
    assert b"__msgpack_chunked_array__" in data
    restored = serialization.msgpack_restore(data)
    np.testing.assert_array_equal(restored["params"]["tok_embed"]
                                  ["embedding"], want)
    assert read_variables(str(port_path))["params"].keys() == \
        restored["params"].keys()


def test_unported_exports_raise(tmp_path):
    meta = _metadata("predict")
    sharded = ModelMetadata.from_json(dict(
        meta.to_json(), sharding={"num_shards": 2}))
    path = tmp_path / "7"
    path.mkdir()
    (path / "signature.json").write_text(sharded.dumps())
    with pytest.raises(NotImplementedError, match="A14"):
        load_version(str(path), device="cpu")
    # batch_stats is served since vision is ported
    # (tests/test_torch_vision.py); another collection still raises.
    other = tmp_path / "8"
    export_model(str(tmp_path), 8, meta, {"params": {}, "intermediates": {}})
    with pytest.raises(NotImplementedError, match="intermediates"):
        load_version(str(other), device="cpu")
