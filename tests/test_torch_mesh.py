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

"""kubeflow_tpu_torch.parallel against kubeflow_tpu.parallel.

The spec arithmetic (``MeshSpec.resolve``, ``respec_for_devices``, the
megascale rules, ``parse_mesh``) and the rule table (``rules_for``,
``logical_to_sharding``) on the same inputs as the reference's; then
every placement: for each mesh position r, the piece the port's
sharding gives rank r is the piece the reference's ``NamedSharding``
gives the device at position r of its mesh over 8 virtual CPU devices
(rank r sits where the reference's device r sits).
"""

import jax
import numpy as np
import pytest

from kubeflow_tpu.parallel import mesh as jmesh
from kubeflow_tpu.parallel import tensor_parallel as jtp
from kubeflow_tpu.training.pretrain import parse_mesh as jax_parse_mesh
from kubeflow_tpu_torch.parallel import mesh as pmesh
from kubeflow_tpu_torch.parallel import tensor_parallel as ptp

SPECS = [
    dict(data=8), dict(fsdp=8), dict(data=2, fsdp=4), dict(data=-1),
    dict(data=2, fsdp=2, tensor=2), dict(dcn_data=2, data=2, fsdp=2),
    dict(fsdp=2, tensor=4), dict(expert=2, data=4), dict(seq=2, data=-1),
]


def _pair(sizes):
    ref = jmesh.build_mesh(jmesh.MeshSpec(**sizes), jax.devices()[:8])
    spec = pmesh.resolve_mesh_spec(pmesh.MeshSpec(**sizes), 8, env={})
    return ref, spec


def _ranks(spec):
    return [pmesh.Mesh(spec, rank=r) for r in range(spec_size(spec))]


def spec_size(spec):
    return int(np.prod(list(spec.sizes().values())))


def assert_same_pieces(ref_sh, port_sh_of_rank, shape, meshes):
    """Rank r's piece == the reference's at mesh position r."""
    pieces = ref_sh.devices_indices_map(shape)
    for r, dev in enumerate(np.asarray(ref_sh.mesh.devices).flat):
        got = port_sh_of_rank(meshes[r]).index(shape)
        want = tuple(pieces[dev])
        norm = lambda idx: tuple(  # noqa: E731
            range(*s.indices(n)) for s, n in zip(idx, shape))
        assert norm(got) == norm(want), (r, got, want)


def test_axis_order_and_megascale_names_are_the_references():
    assert pmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    for name in ("ENV_MEGASCALE_SLICES", "ENV_MEGASCALE_SLICE_ID",
                 "ENV_MEGASCALE_COORD"):
        assert getattr(pmesh, name) == getattr(jmesh, name)
    for env in ({}, {"MEGASCALE_NUM_SLICES": "3"},
                {"MEGASCALE_NUM_SLICES": " "}):
        assert pmesh.slice_count_from_env(env) == (
            jmesh.slice_count_from_env(env))
    with pytest.raises(ValueError):
        pmesh.slice_count_from_env({"MEGASCALE_NUM_SLICES": "0"})


@pytest.mark.parametrize("sizes", SPECS + [dict(data=3), dict(data=-1,
                                                              fsdp=-1)])
def test_resolve_matches_the_reference(sizes):
    for n in (1, 2, 8, 16):
        try:
            want = jmesh.MeshSpec(**sizes).resolve(n).sizes()
        except ValueError:
            with pytest.raises(ValueError):
                pmesh.MeshSpec(**sizes).resolve(n)
            continue
        assert pmesh.MeshSpec(**sizes).resolve(n).sizes() == want


def test_respec_for_devices_math():
    """Twin of tests/test_checkpoint_sharded.py::
    test_respec_for_devices_math, and the same results as the
    reference's on a grid of specs and device counts."""
    spec = pmesh.MeshSpec(data=2, fsdp=2)
    assert pmesh.respec_for_devices(spec, 3).sizes()["data"] == 3
    assert pmesh.respec_for_devices(spec, 3).sizes()["fsdp"] == 1
    out = pmesh.respec_for_devices(spec, 2)
    assert out.sizes()["data"] * out.sizes()["fsdp"] == 2
    assert out.sizes()["fsdp"] == 2
    assert pmesh.respec_for_devices(spec, 4) == pmesh.MeshSpec(data=2,
                                                               fsdp=2)
    with pytest.raises(ValueError):
        pmesh.respec_for_devices(pmesh.MeshSpec(tensor=2, data=2), 3)
    tp = pmesh.respec_for_devices(pmesh.MeshSpec(tensor=2, data=2), 6)
    assert tp.sizes()["tensor"] == 2 and tp.sizes()["data"] == 3
    for sizes in (dict(data=2, fsdp=2), dict(fsdp=-1), dict(tensor=2),
                  dict(fsdp=4, dcn_data=2)):
        for n in range(1, 9):
            try:
                want = jmesh.respec_for_devices(jmesh.MeshSpec(**sizes), n)
            except ValueError:
                with pytest.raises(ValueError):
                    pmesh.respec_for_devices(pmesh.MeshSpec(**sizes), n)
                continue
            got = pmesh.respec_for_devices(pmesh.MeshSpec(**sizes), n)
            assert got.sizes() == want.sizes()


def test_megascale_env_fills_dcn_data_as_the_reference(monkeypatch):
    """Twin of tests/test_engine.py::test_build_mesh_megascale_env: the
    env's slice count fills an unnamed dcn_data, an agreeing one passes,
    a contradicting one raises."""
    monkeypatch.setenv("MEGASCALE_NUM_SLICES", "2")
    for sizes in (dict(data=-1), dict(data=2, fsdp=2),
                  dict(dcn_data=2, data=4)):
        want = jmesh.build_mesh(jmesh.MeshSpec(**sizes)).shape
        got = pmesh.resolve_mesh_spec(pmesh.MeshSpec(**sizes), 8)
        assert got.sizes() == dict(want)
    with pytest.raises(ValueError, match="provisioned"):
        jmesh.build_mesh(jmesh.MeshSpec(dcn_data=4, data=2))
    with pytest.raises(ValueError, match="provisioned"):
        pmesh.resolve_mesh_spec(pmesh.MeshSpec(dcn_data=4, data=2), 8)
    monkeypatch.delenv("MEGASCALE_NUM_SLICES")
    assert pmesh.resolve_mesh_spec(None, 8).sizes()["dcn_data"] == 1


def test_a_mesh_of_one_without_a_process_group():
    mesh = pmesh.build_mesh(pmesh.MeshSpec(fsdp=-1), "cpu")
    assert mesh.size == 1 and mesh.device.type == "cpu"
    assert mesh.group(("fsdp",)) is None
    with pytest.raises(ValueError, match="needs 2 devices"):
        pmesh.build_mesh(pmesh.MeshSpec(data=2), "cpu")


@pytest.mark.parametrize("raw", ["data=2,tensor=4", "fsdp=-1",
                                 " data = 2 , fsdp=4", "", None])
def test_parse_mesh_matches_the_reference(raw):
    assert pmesh.parse_mesh(raw) == (
        None if not raw else pmesh.MeshSpec(**jax_parse_mesh(raw).sizes()))
    with pytest.raises(ValueError):
        pmesh.parse_mesh("data")


@pytest.mark.parametrize("sizes", SPECS)
def test_rank_coordinates_are_the_reference_device_positions(sizes):
    ref, spec = _pair(sizes)
    devices = np.asarray(ref.devices)
    for r in range(8):
        coords = pmesh.Mesh(spec, rank=r).coords()
        pos = tuple(coords[a] for a in pmesh.AXIS_ORDER)
        assert devices[pos] == jax.devices()[r]


@pytest.mark.parametrize("sizes", SPECS)
def test_batch_and_replicated_pieces_are_the_references(sizes):
    ref, spec = _pair(sizes)
    meshes = _ranks(spec)
    for shape in ((16, 3), (8, 4, 2)):
        assert_same_pieces(jmesh.batch_sharding(ref), pmesh.batch_sharding,
                           shape, meshes)
        assert_same_pieces(jmesh.replicated(ref), pmesh.replicated, shape,
                           meshes)


def _tree():
    return {"big/kernel": np.zeros((64, 256), np.float32),
            "tall": np.zeros((512, 24), np.float32),
            "cube": np.zeros((16, 16, 32), np.float32),
            "odd": np.zeros((17, 19, 3, 7), np.float32),
            "small": np.zeros((8,), np.float32)}


@pytest.mark.parametrize("sizes", SPECS)
def test_fsdp_params_pieces_are_the_references(sizes):
    ref, spec = _pair(sizes)
    meshes = _ranks(spec)
    tree = _tree()
    ref_sh = jmesh.fsdp_params_sharding(ref, tree, min_weight_size=64)
    port_sh = [pmesh.fsdp_params_sharding(m, tree, min_weight_size=64)
               for m in meshes]
    for key, leaf in tree.items():
        assert_same_pieces(ref_sh[key],
                           lambda m, key=key: port_sh[m.rank][key],
                           leaf.shape, meshes)


def test_mirror_param_shardings_by_path():
    ref, spec = _pair(dict(fsdp=8))
    mesh = pmesh.Mesh(spec)
    params = {"q": np.zeros((64, 128), np.float32),
              "o": np.zeros((128, 64), np.float32)}
    sh = pmesh.fsdp_params_sharding(mesh, params, min_weight_size=1)
    paths = ["0/mu/q", "0/nu/o", "0/count", "1/q"]
    got = pmesh.mirror_param_shardings(paths, sh, pmesh.replicated(mesh))
    jsh = jmesh.fsdp_params_sharding(ref, params, min_weight_size=1)
    opt = ({"mu": {"q": 0}, "nu": {"o": 0}, "count": 0}, {"q": 0})
    want = jmesh.mirror_param_shardings(opt, jsh, jmesh.replicated(ref))
    flat_want = {"0/mu/q": want[0]["mu"]["q"], "0/nu/o": want[0]["nu"]["o"],
                 "0/count": want[0]["count"], "1/q": want[1]["q"]}
    for path in paths:
        assert got[path].spec == tuple(flat_want[path].spec), path


LOGICAL = {
    "q": ("embed", "heads"),
    "o": ("heads", "embed"),
    "e": ("vocab", "embed"),
    "w_in": ("expert", "embed", "mlp"),
    "router": ("embed", None),
    "lora_a": ("embed", "lora"),
    "dup": ("embed", "embed"),
    "none": None,
}
SHAPES = {"q": (32, 64), "o": (64, 32), "e": (128, 32), "w_in": (4, 32, 64),
          "router": (32, 4), "lora_a": (32, 4), "dup": (32, 32),
          "none": (8,)}


@pytest.mark.parametrize("sizes", SPECS)
def test_rules_and_logical_pieces_are_the_references(sizes):
    ref, spec = _pair(sizes)
    meshes = _ranks(spec)
    assert ptp.DEFAULT_RULES == jtp.DEFAULT_RULES
    rules = ptp.rules_for(meshes[0])
    assert rules == jtp.rules_for(ref)
    assert ptp.rules_for(meshes[0], {"embed": None}) == jtp.rules_for(
        ref, {"embed": None})
    ref_sh = jtp.logical_to_sharding(ref, {k: v for k, v in LOGICAL.items()})
    port_sh = [ptp.logical_to_sharding(m, LOGICAL) for m in meshes]
    # logical_sharding (parallel/mesh.py) maps names as they are: a
    # spec naming one axis twice is the reference's error, so "dup" is
    # logical_to_sharding's case only.
    plain = {k: v for k, v in LOGICAL.items() if k != "dup"}
    ref_ls = jmesh.logical_sharding(ref, plain, jtp.rules_for(ref))
    port_ls = [pmesh.logical_sharding(m, plain, rules) for m in meshes]
    for key, shape in SHAPES.items():
        assert_same_pieces(ref_sh[key], lambda m, k=key: port_sh[m.rank][k],
                           shape, meshes)
        if key in plain:
            assert_same_pieces(ref_ls[key],
                               lambda m, k=key: port_ls[m.rank][k],
                               shape, meshes)


def test_placements_are_shard_or_replicate_per_mesh_axis():
    from torch.distributed.tensor import Replicate, Shard

    _, spec = _pair(dict(data=2, fsdp=2, tensor=2))
    mesh = pmesh.Mesh(spec)
    got = pmesh.Sharding(mesh, (("data", "fsdp"), "tensor")).placements()
    want = {"data": Shard(0), "fsdp": Shard(0), "tensor": Shard(1)}
    assert got == [want.get(a, Replicate()) for a in pmesh.AXIS_ORDER]
    assert pmesh.replicated(mesh).placements() == [Replicate()] * 7


def test_model_axes_raise_naming_a18():
    """What still raises among the model axes, now that ROADMAP A18's
    expert and tensor items run: a step whose model is not known (and
    not checked at its call) refuses tensor; ``pipeline`` runs only in
    the pipeline trainer. ``expert`` and ``tensor`` on a model with no
    param on them are replicated axes, and the Llama and BERT run both
    (``tests/test_torch_expert.py``, ``tests/test_torch_tensor_bert.py``)."""
    from kubeflow_tpu_torch.models.bert import bert_test
    from kubeflow_tpu_torch.models.llama import llama_test

    _, spec = _pair(dict(data=2, fsdp=2, tensor=2))
    mesh = pmesh.Mesh(spec)
    with pytest.raises(NotImplementedError, match="do not run"):
        pmesh.check_batch_axes(mesh, "a step")
    pmesh.check_batch_axes(mesh, "a step", deferred=True)
    pmesh.check_batch_axes(mesh, "a step", llama_test())
    _, spec = _pair(dict(data=2, fsdp=4))
    pmesh.check_batch_axes(pmesh.Mesh(spec), "a step")
    _, spec = _pair(dict(data=2, expert=2, tensor=2))
    mesh = pmesh.Mesh(spec, rank=5)
    for model in (llama_test(), llama_test(num_experts=4), bert_test()):
        pmesh.check_batch_axes(mesh, "a step", model)
    assert pmesh.param_axes(llama_test(num_experts=4)) >= {"expert",
                                                           "tensor"}
    assert "expert" not in pmesh.param_axes(llama_test())
    assert "expert" not in pmesh.param_axes(bert_test())
    assert pmesh.expert_rank(mesh) == 0 and pmesh.tensor_rank(mesh) == 1
    assert pmesh.expert_group(mesh) is None  # no process group
    spec = pmesh.MeshSpec(data=2, pipeline=2)
    with pytest.raises(NotImplementedError, match="pipeline"):
        pmesh.check_batch_axes(pmesh.Mesh(spec), "a step", llama_test())
    pmesh.check_batch_axes(pmesh.Mesh(spec), "a step", llama_test(),
                           pipeline_ok=True)


def test_the_benchmarks_build_their_mesh_from_the_config():
    """training/benchmark.py builds its mesh from the config, as the
    reference's ``build_mesh(config.mesh)``: a mesh of one process
    here, its size the result's chip count."""
    from kubeflow_tpu_torch.training import benchmark

    vision = benchmark.run_benchmark(benchmark.BenchConfig(
        model="resnet-test", batch_size=4, steps=1, warmup_steps=1,
        image_size=32, mesh=pmesh.MeshSpec(data=-1)), device="cpu")
    lm = benchmark.run_lm_benchmark(benchmark.LMBenchConfig(
        model="llama-test", batch_size=2, seq_len=16, steps=1,
        warmup_steps=1, objective="causal",
        mesh=pmesh.MeshSpec(fsdp=-1)), device="cpu")
    for result in (vision, lm):
        assert result["n_chips"] == 1
        assert np.isfinite(result["final_loss"] if "final_loss" in result
                           else result["losses"][-1])
