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

"""The port's mesh LM trainers in a 2-rank gloo gang against the
reference's on meshes of the same sizes.

One gang runs every case of the file (``_torch_gang.py``); the
reference runs in this process on two of its virtual CPU devices. Each
case starts both sides from the reference's meshed init (carried across
to the port and cut to its pieces) and feeds the same global batches:
each rank takes its rows, the reference places the whole batch by
``batch_sharding``. Meshes: ``data=2``, ``fsdp=2`` and ``dcn_data=2``
from the megascale env (``MEGASCALE_NUM_SLICES=2``). Models:
``llama-test`` pretraining (the pretrain CLI's clipped adamw chain, on
padded rows, so the ranks' token counts differ) and LoRA, three steps
each, and ``bert-test`` mlm with uneven masks. Tolerances: the loss at
each step within ``LOSS_RTOL`` = 1e-5 relative and the grad norm within
1e-4 (those of ``tests/test_torch_lm.py``); params, adapters and
optimizer moments after the last step within 5e-4 (fp32 sums in another
order than XLA's, across ranks, grown by three Adam steps). Also: the
gang's ``DevicePrefetcher`` gives each rank the rows of the reference's
batch sharding (twin of ``tests/test_data_loop.py::
test_prefetcher_places_on_mesh``).
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from _torch_gang import run_gang
from _torch_training import VOCAB, flat, reference_flat_state
from kubeflow_tpu.models.llama import llama_test as jax_llama_test
from kubeflow_tpu.models.registry import get_model as jax_get_model
from kubeflow_tpu.parallel.mesh import MeshSpec, batch_sharding, build_mesh
from kubeflow_tpu.training import finetune as jft
from kubeflow_tpu.training import lm as jlm
from kubeflow_tpu.training.data import synthetic_causal_lm
from kubeflow_tpu_torch.models.convert import flax_key

LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
PARAM_TOL = 5e-4
STEPS = 3

SPECS = {
    "data": ({"data": 2}, {}),
    "fsdp": ({"fsdp": 2}, {}),
    "dcn": ({"data": -1}, {"MEGASCALE_NUM_SLICES": "2"}),
}
MODELS = ("pretrain", "lora", "bert")

TXS = {
    "adamw": lambda: optax.adamw(1e-3),
    "pretrain_chain": lambda: optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adamw(optax.schedules.warmup_cosine_decay_schedule(
            0.0, 1e-3, 2, 10), weight_decay=0.01)),
}


@contextlib.contextmanager
def environ(env):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def causal_batches(seed):
    """Padded causal rows: the second half of the batch (rank 1's rows)
    keeps fewer tokens than the first."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(0, VOCAB, (4, 32)).astype(np.int32)
        w = np.ones((4, 32), np.float32)
        w[2:, 20:] = 0.0
        w[3, 9:] = 0.0
        out.append({"input_ids": ids, "loss_weights": w})
    return out


def mlm_batches(seed):
    """BERT mlm batches whose masks differ in count between the halves."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(0, VOCAB, (4, 32)).astype(np.int32)
        rate = np.array([[0.5], [0.4], [0.1], [0.05]])
        weights = (rng.random((4, 32)) < rate).astype(np.int32)
        weights[:, 0] = 1
        out.append({"input_ids": ids,
                    "type_ids": rng.integers(0, 2, (4, 32)).astype(np.int32),
                    "valid": np.ones((4, 32), np.int32),
                    "mlm_labels": rng.integers(0, VOCAB, (4, 32))
                    .astype(np.int32),
                    "mlm_weights": weights})
    return out


def reference_case(kind, spec_name):
    """(reference state, step, mesh, the port's case)."""
    spec, env = SPECS[spec_name]
    with environ(env):
        mesh = build_mesh(MeshSpec(**spec), jax.devices()[:2])
    rng = jax.random.PRNGKey(1)
    case = {"name": f"{kind}-{spec_name}", "spec": spec, "env": env}
    if kind == "bert":
        batches = mlm_batches(3)
        model = jax_get_model("bert-test").make(dtype=jnp.float32)
        tx = "adamw"
        state, sh = jlm.create_lm_state(model, TXS[tx](), rng, batches[0],
                                        mesh)
        step = jlm.make_lm_train_step(mesh, sh, objective="mlm",
                                      donate=False)
        case.update(model="bert-test", kwargs={"dtype": "float32"},
                    objective="mlm", params=flat(state.params), lora=None)
    elif kind == "lora":
        batches = [{"input_ids": b["input_ids"]} for b in causal_batches(4)]
        model = jax_llama_test(dtype=jnp.float32, lora_rank=4)
        tx = "adamw"
        state, sh = jft.create_lora_state(model, TXS[tx](), rng, batches[0],
                                          mesh)
        step = jft.make_lora_train_step(mesh, sh, donate=False)
        case.update(model="llama-test",
                    kwargs={"dtype": "float32", "lora_rank": 4},
                    objective="causal", params=flat(state.base_params),
                    lora=flat(state.lora))
    else:
        batches = causal_batches(5)
        model = jax_llama_test(dtype=jnp.float32)
        tx = "pretrain_chain"
        state, sh = jlm.create_lm_state(model, TXS[tx](), rng, batches[0],
                                        mesh)
        step = jlm.make_lm_train_step(mesh, sh, donate=False)
        case.update(model="llama-test", kwargs={"dtype": "float32"},
                    objective="causal", params=flat(state.params), lora=None)
    case.update(tx=tx, batches=batches)
    return state, step, mesh, case


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Each case's reference (state, step, mesh, case) and the gang's
    results: ranks 0 and 1, by case name."""
    refs = {(k, s): reference_case(k, s) for k in MODELS for s in SPECS}
    cases = [r[3] for r in refs.values()]
    prefetch = [{"name": "prefetch-data", "spec": {"data": 2}, "env": {},
                 "global_batch": 16}]
    ranks = run_gang("lm", cases, tmp_path_factory.mktemp("gang-lm"))
    fetched = run_gang("prefetch", prefetch,
                       tmp_path_factory.mktemp("gang-prefetch"))
    return refs, ranks, fetched


@pytest.mark.parametrize("spec_name", sorted(SPECS))
@pytest.mark.parametrize("kind", MODELS)
def test_gang_step_matches_the_reference_mesh(gang, kind, spec_name):
    refs, ranks, _ = gang
    state, step, mesh, case = refs[(kind, spec_name)]
    name = case["name"]
    port = ranks[0][name]
    assert port["mesh"] == {k: int(v) for k, v in mesh.shape.items()}
    # Both ranks report the same global metrics and the same state.
    assert ranks[0][name]["metrics"] == ranks[1][name]["metrics"]
    for i, batch in enumerate(case["batches"]):
        state, m = step(state, jax.device_put(batch, batch_sharding(mesh)))
        got = port["metrics"][i]
        np.testing.assert_allclose(got["loss"], float(m["loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]),
                                   rtol=NORM_RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(got["accuracy"], float(m["accuracy"]),
                                   rtol=1e-5, atol=1e-6)
    fields = ("step", "lora", "opt_state") if kind == "lora" else (
        "step", "params", "opt_state")
    ref = reference_flat_state(state, fields)
    for r in (0, 1):
        flat_port = {k: v for k, v in ranks[r][name]["state"].items()
                     if k.split("/")[0] in fields}
        assert set(flat_port) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(
                np.asarray(flat_port[k], np.float64),
                np.asarray(v, np.float64), rtol=PARAM_TOL, atol=PARAM_TOL,
                err_msg=f"rank {r} {k}")
    if spec_name == "fsdp":
        # The embed dims are split over the two ranks: the token table
        # [vocab, d] holds half of d on each.
        pieces = {flax_key(n): shape for n, shape in port["pieces"].items()}
        if kind == "lora":
            # An adapter's in-axis of embed is split: (embed, lora).
            key = "layer_0/attention/q_proj/lora_a"
            assert pieces[key][0] * 2 == case["lora"][key].shape[0]
        else:
            key = "tok_embed/embedding"
            assert pieces[key][1] * 2 == case["params"][key].shape[1]


def test_gang_prefetcher_places_each_rank_its_rows(gang):
    """Twin of tests/test_data_loop.py::test_prefetcher_places_on_mesh:
    each rank's batch is the piece the reference's batch sharding puts
    on the device at its mesh position."""
    _, _, fetched = gang
    mesh = build_mesh(MeshSpec(data=2), jax.devices()[:2])
    ref = jax.device_put(next(synthetic_causal_lm(16, seq_len=8,
                                                  vocab_size=64)),
                         batch_sharding(mesh))["input_ids"]
    pieces = ref.sharding.devices_indices_map(ref.shape)
    for r, dev in enumerate(mesh.devices.flat):
        got = fetched[r]["prefetch-data"]
        assert got["device"] == "cpu"
        np.testing.assert_array_equal(got["input_ids"],
                                      np.asarray(ref)[pieces[dev]])
