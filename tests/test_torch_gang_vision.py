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

"""The port's meshed vision step in a 2-rank gloo gang against the
reference's on meshes of the same sizes.

Twin of ``tests/test_classic_cnn.py::test_vgg_dp_fsdp_mesh_step`` as
``fsdp=2`` and ``data=2`` cases, on a VGG of the test config's stages
with 1024-wide FC layers, so that fc1 and fc2 pass the reference's
``min_weight_size=2**18`` and are split over fsdp (the test config's
64-wide layers split nothing). Then ``resnet-test`` with exact BN on
``data=2`` and ``fsdp=2``: every BN layer on the sync route (its
statistics are the global batch's, as the reference's BN reduces them
across devices), held to the reference's mesh step; and with
``bn_stat_rows=4`` on ``data=2``, where the reference takes the global
batch's first four images, all on rank 0 (ResNet at
``tests/test_torch_train.py``'s geometry: 16 images of 64²). Three SGD
(nesterov) steps
from the reference's init: loss, accuracy and grad norm at each step,
params and BN statistics after the last, within 1e-4 (the tolerance of
``tests/test_torch_train.py``'s unmeshed ResNet case).
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from _torch_gang import run_gang
from _torch_training import flat
from kubeflow_tpu.models.classic_cnn import VGG as JaxVGG
from kubeflow_tpu.models.resnet import resnet18ish as jax_resnet18ish
from kubeflow_tpu.parallel.mesh import MeshSpec, build_mesh
from kubeflow_tpu.training.train import (
    create_train_state,
    make_train_step,
    place_batch,
    place_state,
)

TOL = dict(atol=1e-4, rtol=1e-4)
STEPS = 3
LR = 0.1

VGG_KW = dict(stage_sizes=(1, 1, 1), widths=(8, 16, 32), num_classes=10,
              dense_width=1024)
CASES = {
    "vgg-fsdp": ("vgg", {"fsdp": 2}, 0),
    "vgg-data": ("vgg", {"data": 2}, 0),
    "resnet-data": ("resnet", {"data": 2}, 0),
    "resnet-fsdp": ("resnet", {"fsdp": 2}, 0),
    "resnet-ghost-data": ("resnet", {"data": 2}, 4),
}


def _batches(n, size):
    rng = np.random.RandomState(7)
    return [{"inputs": rng.randn(n, size, size, 3).astype(np.float32),
             "labels": rng.randint(0, 10, (n,)).astype(np.int32)}
            for _ in range(STEPS)]


def reference_case(name):
    kind, spec, stat_rows = CASES[name]
    mesh = build_mesh(MeshSpec(**spec), jax.devices()[:2])
    tx = optax.sgd(LR, momentum=0.9, nesterov=True)
    if kind == "vgg":
        n, size = 8, 32
        model = JaxVGG(dtype=jnp.float32, **VGG_KW)
        port = {"factory": "kubeflow_tpu_torch.models.classic_cnn:VGG",
                "kwargs": dict(VGG_KW, dtype="float32", image_size=size,
                               device="meta")}
    else:
        # tests/test_torch_train.py's geometry: 16 images of 64².
        n, size = 16, 64
        model = jax_resnet18ish(dtype=jnp.float32, bn_stat_rows=stat_rows)
        port = {"model": "resnet-test",
                "kwargs": {"dtype": "float32", "bn_stat_rows": stat_rows}}
    state = jax.jit(lambda r: create_train_state(
        model, tx, r, jnp.zeros((1, size, size, 3))))(jax.random.PRNGKey(0))
    case = dict(port, name=name, spec=spec, env={}, lr=LR, momentum=0.9,
                params=flat(state.params),
                batch_stats=(flat(state.batch_stats)
                             if state.batch_stats is not None else None),
                batches=_batches(n, size))
    return place_state(mesh, state), make_train_step(mesh, donate=False), \
        mesh, case


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    refs = {name: reference_case(name) for name in CASES}
    ranks = run_gang("vision", [r[3] for r in refs.values()],
                     tmp_path_factory.mktemp("gang-vision"))
    return refs, ranks


@pytest.mark.parametrize("name", sorted(CASES))
def test_gang_vision_step_matches_the_reference_mesh(gang, name):
    refs, ranks = gang
    state, step, mesh, case = refs[name]
    port = ranks[0][name]
    assert ranks[1][name]["metrics"] == port["metrics"]
    for i, batch in enumerate(case["batches"]):
        state, m = step(state, place_batch(mesh, batch))
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(port["metrics"][i][key],
                                       float(m[key]),
                                       err_msg=f"{key} step {i}", **TOL)
    for r in (0, 1):
        got = ranks[r][name]["params"]
        want = flat(state.params)
        assert set(got) == set(want)
        for key, value in want.items():
            np.testing.assert_allclose(got[key], np.asarray(value),
                                       err_msg=f"rank {r} {key}", **TOL)
    if case["batch_stats"]:
        # Every BN layer took the sync route (one stats call a layer a
        # step, on a rank that holds stat rows), and the running
        # statistics are the global batch's.
        assert port["stats_calls"] > 0
        for key, value in flat(state.batch_stats).items():
            np.testing.assert_allclose(
                port["batch_stats"][key.replace("/", ".")],
                np.asarray(value), err_msg=key, **TOL)
    if case["spec"] == {"fsdp": 2} and "factory" in case:
        # fc1 and fc2 (≥ 2**18 elements) are split over the two ranks.
        for fc in ("fc1.weight", "fc2.weight"):
            whole = case["params"][fc.replace(".weight", "/kernel")].shape
            assert np.prod(port["pieces"][fc]) * 2 == np.prod(whole), fc
