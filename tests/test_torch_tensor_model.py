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

"""The tensor-parallel Llama's layer, without a gang.

A Llama built on a mesh of one process with ``tensor=2`` at position r
(no process group: every tensor collective is then the identity) holds
rank r's pieces. Held here: each leaf's piece is the one the
reference's rule table gives the device at position r
(``NamedSharding.devices_indices_map``), except k/v where the port
splits by kv-head group (the columns of the kv heads rank r's query
heads read) and the reference keeps them whole; a KV cache holds the
rank's kv heads, or every kv head where ``Hkv % T != 0``; a tensor axis
of 1 builds the model of no mesh, with the same bits; given the mesh, a
rank reads the batch rows of its batch position. And the raises:
``seq``, ``expert``, ``pipeline``; ``tensor`` on BERT, ViT, a CNN and
an MoE Llama; a serving manifest with ``fsdp > 1``, each naming A18.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as nn
from kubeflow_tpu.models.llama import llama_test as jax_llama_test
from kubeflow_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from kubeflow_tpu.parallel.mesh import batch_sharding as jax_batch_sharding
from kubeflow_tpu.parallel.mesh import build_mesh as jax_build_mesh
from kubeflow_tpu.parallel.tensor_parallel import (
    logical_to_sharding as jax_logical_to_sharding,
)
from _torch_gang import run_gang
from kubeflow_tpu_torch.inference.generate import init_cache
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.llama import Llama, apply, llama_test
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.parallel.mesh import Mesh, MeshSpec, check_batch_axes
from kubeflow_tpu_torch.parallel.tensor_parallel import kv_group, tensor_piece
from kubeflow_tpu_torch.serving import sharding
from kubeflow_tpu_torch.training import optim
from kubeflow_tpu_torch.training.data import (
    host_shard_range,
    process_index_and_count,
)
from kubeflow_tpu_torch.training.lm import create_lm_state
from kubeflow_tpu_torch.training.train import make_train_step


def fake_mesh(rank, **sizes):
    """A mesh of one process standing at ``rank``."""
    return Mesh(MeshSpec(**sizes), rank=rank, device="cpu")


@pytest.fixture(scope="module")
def reference():
    model = jax_llama_test(dtype=jnp.float32)
    boxed = jax.jit(model.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))
    mesh = jax_build_mesh(JaxMeshSpec(tensor=2), jax.devices()[:2])
    shardings = jax_logical_to_sharding(
        mesh, nn.get_partition_spec(boxed))["params"]
    params = {k: np.asarray(v) for k, v in convert.flatten_tree(
        nn.meta.unbox(boxed)["params"]).items()}
    return params, convert.flatten_tree(shardings), mesh


@pytest.mark.parametrize("rank", [0, 1])
def test_each_leaf_is_the_reference_rule_tables_piece(reference, rank):
    params, shardings, mesh = reference
    model = llama_test(dtype="float32", mesh=fake_mesh(rank, tensor=2))
    local = convert.params_to_flax(convert.params_from_flax(
        params, model, device="cpu"))
    device = mesh.devices.flat[rank]
    for key, whole in params.items():
        piece = shardings[key].devices_indices_map(whole.shape)[device]
        if "/k_proj/" in key or "/v_proj/" in key:
            # The reference keeps k/v whole (kv → None); rank r holds the
            # columns of kv head r (Hkv = 2 over tensor = 2).
            assert shardings[key].is_fully_replicated
            want = whole[:, rank * 16:(rank + 1) * 16]
        else:
            want = whole[piece]
        np.testing.assert_array_equal(local[key], want, err_msg=key)
        got = tensor_piece(model, key, whole.shape, model.mesh)
        assert np.array_equal(whole[got], want), key


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_2d_pieces_on_fsdp_and_tensor(reference, rank):
    """``params_from_flax(mesh=)`` on ``fsdp=2, tensor=2``: each leaf
    cut on its embed dim over fsdp and its heads, mlp or vocab dim over
    tensor, the piece the reference's rule table gives the device at
    position r (k/v: the kv-head group's columns, then embed's half)."""
    params, _, _ = reference
    mesh = jax_build_mesh(JaxMeshSpec(fsdp=2, tensor=2), jax.devices()[:4])
    model = jax_llama_test(dtype=jnp.float32)
    boxed = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                           jnp.zeros((1, 8), jnp.int32))
    shardings = convert.flatten_tree(jax_logical_to_sharding(
        mesh, nn.get_partition_spec(boxed))["params"])
    port = fake_mesh(rank, fsdp=2, tensor=2)
    local = convert.params_to_flax(convert.params_from_flax(
        params, llama_test(dtype="float32", mesh=port), "cpu", mesh=port))
    device = mesh.devices.flat[rank]
    tensor, fsdp = port.coords()["tensor"], port.coords()["fsdp"]
    for key, whole in params.items():
        if "/k_proj/" in key or "/v_proj/" in key:
            want = whole[fsdp * 32:(fsdp + 1) * 32,
                         tensor * 16:(tensor + 1) * 16]
        else:
            want = whole[shardings[key].devices_indices_map(
                whole.shape)[device]]
        np.testing.assert_array_equal(local[key], want, err_msg=key)


ROW_MESHES = ({"data": 2, "tensor": 2}, {"fsdp": 2, "tensor": 2},
              {"tensor": 2})


@pytest.mark.parametrize("sizes,rank", [
    (sizes, rank) for sizes in ROW_MESHES
    for rank in range(int(np.prod(list(sizes.values()))))])
def test_a_ranks_rows_are_its_batch_position(sizes, rank):
    """Given the mesh, a rank reads the rows of the global batch that
    the reference's ``batch_sharding`` gives the device at its position:
    the ranks of one tensor line read the same rows."""
    world = int(np.prod(list(sizes.values())))
    mesh = jax_build_mesh(JaxMeshSpec(**sizes), jax.devices()[:world])
    want = jax_batch_sharding(mesh).devices_indices_map(
        (8,))[mesh.devices.flat[rank]][0]
    port = fake_mesh(rank, **sizes)
    got = host_shard_range(8, mesh=port)
    assert (got.start, got.stop) == (want.start or 0, want.stop or 8)
    assert process_index_and_count(port)[1] == 8 // len(got)


def test_kv_groups_and_cache_heads():
    """Hkv % T == 0: each rank's cache holds its own kv heads, and its
    query heads index them from 0; otherwise every kv head, indexed by
    the query head's group."""
    assert kv_group(32, 8, 2, 1) == [h // 4 - 4 for h in range(16, 32)]
    assert kv_group(4, 1, 2, 1) == [0, 0]
    assert kv_group(12, 3, 2, 1) == [1, 1, 2, 2, 2, 2]
    split = llama_test(dtype="float32", cache_size=16,
                       mesh=fake_mesh(1, tensor=2))
    whole = Llama(vocab_size=512, num_layers=2, d_model=64, num_heads=4,
                  num_kv_heads=1, mlp_dim=128, dtype="float32",
                  cache_size=16, mesh=fake_mesh(1, tensor=2))
    params = {"x": torch.zeros(1)}
    assert init_cache(split, params, 2)[0].k.shape == (2, 16, 1, 16)
    assert init_cache(whole, params, 2)[0].k.shape == (2, 16, 1, 16)
    assert split.layers[0].attention.kv_index is None
    assert whole.layers[0].attention.kv_index.tolist() == [0, 0]
    assert whole.layers[0].attention.q_proj.weight.shape == (32, 64)
    assert whole.layers[0].attention.k_proj.weight.shape == (16, 64)


def test_a_tensor_axis_of_one_is_the_model_of_no_mesh(reference):
    params, _, _ = reference
    plain = llama_test(dtype="float32")
    meshed = llama_test(dtype="float32", mesh=fake_mesh(0, data=1))
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 512,
                                                             (2, 12)))
    a = apply(plain, convert.params_from_flax(params, plain, "cpu"), ids)
    b = apply(meshed, convert.params_from_flax(params, meshed, "cpu"), ids)
    assert torch.equal(a, b)


@pytest.mark.parametrize("axis", ["seq", "expert", "pipeline"])
def test_the_other_model_axes_raise_naming_a18(axis):
    """Of the other model axes only ``pipeline`` still raises outside the
    pipeline trainer: ``seq`` is a replicated axis everywhere, and so is
    ``expert`` on a dense Llama, which has no param on it (an MoE
    Llama's expert split: tests/test_torch_expert.py)."""
    model = llama_test(dtype="float32")
    sizes = {axis: 2} if axis != "seq" else {"seq": 2, "expert": 2}
    if axis == "pipeline":
        with pytest.raises(NotImplementedError, match="pipeline LM"):
            check_batch_axes(fake_mesh(0, **sizes), "a step", model)
        with pytest.raises(NotImplementedError, match="pipeline LM"):
            create_lm_state(model, optim.sgd(0.1), {},
                            mesh=fake_mesh(0, **sizes))
        return
    check_batch_axes(fake_mesh(0, **sizes), "a step", model)
    _, shardings = create_lm_state(model, optim.sgd(0.1), {},
                                   mesh=fake_mesh(0, **sizes))
    assert shardings == {}


@pytest.mark.parametrize("name", ["bert-test", "vit-test", "resnet-test",
                                  "llama-moe-test"])
def test_tensor_on_other_models_raises_naming_a18(name):
    """``tensor`` runs for BERT and the MoE Llama built on the mesh
    (tests/test_torch_tensor_bert.py, tests/test_torch_expert.py); one
    not built on it raises. The vision trainer runs it as a replicated
    axis, as the reference's does (its params are laid out by fsdp
    alone). What still raises: the LM trainers' check of ViT, whose
    heads and mlp the rule table maps to tensor but which has no
    tensor-parallel layers."""
    mesh = fake_mesh(0, tensor=2)
    model = get_model(name).make(dtype="float32")
    if get_model(name).family == "vision":
        assert callable(make_train_step(mesh=mesh))
        if name == "vit-test":
            with pytest.raises(NotImplementedError, match="do not run"):
                check_batch_axes(mesh, "a step", model)
        else:
            check_batch_axes(mesh, "a step", model)
        return
    check_batch_axes(mesh, "a step", model)
    with pytest.raises(ValueError, match="built on it"):
        create_lm_state(model, optim.sgd(0.1), {}, mesh=mesh)
    built = get_model(name).make(dtype="float32", mesh=mesh)
    _, shardings = create_lm_state(built, optim.sgd(0.1), {}, mesh=mesh)
    assert shardings == {}


def test_a_serving_manifest_with_fsdp_raises_naming_a18():
    """An fsdp manifest builds its serving mesh since A18's fsdp
    serving forward: what still raises is a group too small for it, with
    the reference's message."""
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        sharding.serving_mesh(sharding.ShardSpec(tensor=2, fsdp=2), "cpu")


def test_a_three_rank_sum_is_in_rank_order_whatever_the_batch(tmp_path):
    """Over more than two tensor ranks the row-parallel sum is the
    pieces added in rank order: a row has the same bits alone and in a
    batch of 4, on every rank (an all-reduce's order follows the
    buffer's size); the head's gather joins the pieces in rank order."""
    rng = np.random.default_rng(7)
    rows = rng.standard_normal((3, 4, 8)).astype(np.float32) * 10
    ranks = run_gang("tensor_sum", [{"name": "sum", "spec": {"tensor": 3},
                                     "rows": rows}], tmp_path, world=3)
    for dtype in (torch.float32, torch.bfloat16):
        pieces = torch.from_numpy(rows).to(dtype)
        want = pieces[0] + pieces[1] + pieces[2]
        name = str(dtype).replace("torch.", "")
        for res in ranks:
            got = res["sum"][name]
            np.testing.assert_array_equal(got[4], want.float().numpy())
            np.testing.assert_array_equal(got[1], got[4][:1])
    for res in ranks:
        np.testing.assert_array_equal(res["sum"]["gather"],
                                      np.concatenate(list(rows), axis=-1))
