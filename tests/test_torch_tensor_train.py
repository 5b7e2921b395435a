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

"""The port's tensor-parallel LM and LoRA steps in gloo gangs against the
reference's steps on meshes of the same sizes.

A 4-rank gang runs ``fsdp=2, tensor=2`` (the 2-D leaves: a q kernel
split on embed over fsdp and on heads over tensor) and a 2-rank gang
``tensor=2``; the reference runs in this process on its virtual CPU
devices (``tests/test_lm.py::test_llama_causal_train_step_tp`` and
``tests/test_lora.py::test_lora_sharded_step_runs_on_mesh`` are its own
tensor cases). Each case starts both sides from the reference's meshed
init, carried across and cut to the rank's pieces, and takes three
steps on the same global batches. Held: the losses within ``LOSS_TOL``
(1e-4, fp32) at each step, the grad norm within 1e-4 relative, the
gathered params (or adapters) after the steps within ``PARAM_TOL``
(1e-4), each leaf's 2-D layout and its moments' (by path), and the
k/v case the reference's rule table does not split
(``num_kv_heads=1`` at ``tensor=2``: every rank holds the whole kernel
and the gradient of the columns its heads read is summed over the
tensor line). Checkpoints cross tensor sizes both ways: the ``tensor=2``
pretraining case starts from a one-rank run's checkpoint of the init,
and its own checkpoint after three steps restores into a one-rank state
whose fourth step's loss equals the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from _torch_gang import run_gang
from _torch_training import VOCAB, flat, reference_flat_state
from kubeflow_tpu.models.llama import Llama as JaxLlama
from kubeflow_tpu.models.llama import llama_test as jax_llama_test
from kubeflow_tpu.parallel.mesh import MeshSpec, batch_sharding, build_mesh
from kubeflow_tpu.training import finetune as jft
from kubeflow_tpu.training import lm as jlm
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.llama import llama_test
from kubeflow_tpu_torch.training import lm, optim
from kubeflow_tpu_torch.training.checkpoint import (
    ContinuousCheckpointConfig,
    ShardedCheckpointer,
)

LOSS_TOL = 1e-4
NORM_RTOL = 1e-4
PARAM_TOL = 1e-4
STEPS = 3

TXS = {
    "adamw": lambda: optax.adamw(1e-3),
    "pretrain_chain": lambda: optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adamw(optax.schedules.warmup_cosine_decay_schedule(
            0.0, 1e-3, 2, 10), weight_decay=0.01)),
}

#: name → (mesh sizes, kind, model kwargs beyond llama-test's).
CASES = {
    "pretrain-fsdp2-tensor2": ({"fsdp": 2, "tensor": 2}, "pretrain", {}),
    "lora-fsdp2-tensor2": ({"fsdp": 2, "tensor": 2}, "lora", {}),
    "pretrain-tensor2-checkpoints": ({"tensor": 2}, "pretrain", {}),
    "kv1-tensor2": ({"tensor": 2}, "kv1", {}),
}


def causal_batches(seed, steps=STEPS):
    """Padded causal rows (the loss's token count differs by row)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ids = rng.integers(0, VOCAB, (4, 32)).astype(np.int32)
        w = np.ones((4, 32), np.float32)
        w[2:, 20:] = 0.0
        out.append({"input_ids": ids, "loss_weights": w})
    return out


def kv1_model(jax_side, **kw):
    """llama-test's widths with one kv head (MQA)."""
    widths = dict(vocab_size=VOCAB, num_layers=2, d_model=64, num_heads=4,
                  num_kv_heads=1, mlp_dim=128)
    if jax_side:
        return JaxLlama(dtype=jnp.float32, **widths, **kw)
    return widths


def reference_case(name, tmp):
    """(reference state, step, mesh, batches, the port's case)."""
    spec, kind, _ = CASES[name]
    devices = jax.devices()[:int(np.prod(list(spec.values())))]
    mesh = build_mesh(MeshSpec(**spec), devices)
    rng = jax.random.PRNGKey(1)
    case = {"name": name, "spec": spec, "env": {}, "objective": "causal"}
    batches = causal_batches(5, STEPS + 1)
    if kind == "lora":
        batches = [{"input_ids": b["input_ids"]} for b in batches]
        model = jax_llama_test(dtype=jnp.float32, lora_rank=4)
        tx = "adamw"
        state, sh = jft.create_lora_state(model, TXS[tx](), rng, batches[0],
                                          mesh)
        step = jft.make_lora_train_step(mesh, sh, donate=False)
        case.update(model="llama-test",
                    kwargs={"dtype": "float32", "lora_rank": 4},
                    params=flat(state.base_params), lora=flat(state.lora))
    else:
        if kind == "kv1":
            model = kv1_model(True)
            case.update(factory="kubeflow_tpu_torch.models.llama:Llama",
                        kwargs={"dtype": "float32", **kv1_model(False)})
            tx = "adamw"
        else:
            model = jax_llama_test(dtype=jnp.float32)
            case.update(model="llama-test", kwargs={"dtype": "float32"})
            tx = "pretrain_chain"
        state, sh = jlm.create_lm_state(model, TXS[tx](), rng, batches[0],
                                        mesh)
        step = jlm.make_lm_train_step(mesh, sh, donate=False)
        case.update(params=flat(state.params), lora=None)
    case.update(tx=tx, batches=batches[:STEPS])
    if name == "pretrain-tensor2-checkpoints":
        # The init through a one-rank run's checkpoint, and the gang's
        # state after its steps into a checkpoint of its own.
        port_model = llama_test(dtype="float32")
        params = convert.params_from_flax(case["params"], port_model,
                                          device="cpu")
        one, _ = lm.create_lm_state(port_model, PORT_TXS[tx](), params)
        writer = ShardedCheckpointer(ContinuousCheckpointConfig(
            directory=str(tmp / "init"), async_save=False))
        writer.save(0, one, force=True)
        writer.close()
        case.update(restore_dir=str(tmp / "init"),
                    save_dir=str(tmp / "after"))
    return state, step, mesh, batches, case


PORT_TXS = {
    "adamw": lambda: optim.adamw(1e-3),
    "pretrain_chain": lambda: optim.chain(
        optim.clip_by_global_norm(1.0),
        optim.adamw(optim.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10),
                    weight_decay=0.01)),
}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Each case's reference and the gangs' results by case name (a
    list over ranks)."""
    tmp = tmp_path_factory.mktemp("tensor-train")
    refs = {n: reference_case(n, tmp) for n in CASES}
    results = {}
    for world in (4, 2):
        cases = [r[4] for n, r in refs.items()
                 if int(np.prod(list(CASES[n][0].values()))) == world]
        ranks = run_gang("lm", cases, tmp / f"gang{world}", world=world)
        for case in cases:
            results[case["name"]] = [r[case["name"]] for r in ranks]
    return refs, results


@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_step_matches_the_reference_mesh(gang, name):
    refs, results = gang
    state, step, mesh, batches, case = refs[name]
    ranks = results[name]
    assert ranks[0]["mesh"] == {k: int(v) for k, v in mesh.shape.items()}
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
    for i, batch in enumerate(case["batches"]):
        state, m = step(state, jax.device_put(batch, batch_sharding(mesh)))
        got = ranks[0]["metrics"][i]
        np.testing.assert_allclose(got["loss"], float(m["loss"]),
                                   rtol=0, atol=LOSS_TOL,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]),
                                   rtol=NORM_RTOL, err_msg=f"step {i}")
    fields = ("step", "lora", "opt_state") if case["lora"] is not None \
        else ("step", "params", "opt_state")
    ref = reference_flat_state(state, fields)
    for r, res in enumerate(ranks):
        port = {k: v for k, v in res["state"].items()
                if k.split("/")[0] in fields}
        assert set(port) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(
                np.asarray(port[k], np.float64), np.asarray(v, np.float64),
                rtol=PARAM_TOL, atol=PARAM_TOL, err_msg=f"rank {r} {k}")


def test_leaves_split_in_two_dims_and_moments_follow_by_path(gang):
    """On ``fsdp=2, tensor=2`` a q kernel ([out, in] in the port) is
    split on its heads over tensor and on embed over fsdp; k and v by
    kv-head group; the moments carry each param's layout by path (the
    reference's ``tests/test_lm.py:163-190``)."""
    _, results = gang
    res = results["pretrain-fsdp2-tensor2"][0]
    specs = res["specs"]
    assert specs["layer_0/attention/q_proj/kernel"] == ("tensor", "fsdp")
    assert specs["layer_0/attention/k_proj/kernel"] == ("tensor", "fsdp")
    assert specs["layer_0/attention/o_proj/kernel"] == ("fsdp", "tensor")
    assert specs["layer_0/down_proj/kernel"] == ("fsdp", "tensor")
    assert specs["tok_embed/embedding"] == ("tensor", "fsdp")
    assert specs["lm_head/kernel"] == ("tensor", "fsdp")
    assert specs["layer_0/attn_norm/scale"] == (None,)
    pieces = {convert.flax_key(k): v for k, v in res["pieces"].items()}
    assert pieces["layer_0/attention/q_proj/kernel"] == (32, 32)
    assert pieces["layer_0/attention/k_proj/kernel"] == (16, 32)
    assert pieces["tok_embed/embedding"] == (256, 32)
    moments = 0
    for path, spec in res["moments"].items():
        keys = path.split("/")
        for i, k in enumerate(keys):
            if k in ("mu", "nu"):
                assert spec == specs["/".join(keys[i + 1:])], path
                moments += 1
    assert moments == 2 * len(specs)
    lora = results["lora-fsdp2-tensor2"][0]["specs"]
    # q's adapter B is split on its output (heads), o's adapter A on its
    # input (heads); their other halves are whole over tensor.
    assert lora["layer_0/attention/q_proj/lora_b"] == (None, "tensor")
    assert lora["layer_0/attention/o_proj/lora_a"][0] == "tensor"
    assert lora["layer_0/attention/q_proj/lora_a"][1] is None


def test_unsplit_kv_kernels_stay_whole_and_agree(gang):
    """``num_kv_heads=1`` at ``tensor=2``: the k/v kernels are whole on
    both ranks and equal after the steps (their summed gradients), and
    each rank's q kernel is its half."""
    _, results = gang
    ranks = results["kv1-tensor2"]
    pieces = {convert.flax_key(n): s for n, s in ranks[0]["pieces"].items()}
    for k in ("layer_0/attention/k_proj/kernel",
              "layer_1/attention/v_proj/kernel"):
        assert ranks[0]["specs"][k] == (None, None)
        assert pieces[k] == (16, 64)
        np.testing.assert_array_equal(ranks[0]["state"][f"params/{k}"],
                                      ranks[1]["state"][f"params/{k}"])
    assert pieces["layer_0/attention/q_proj/kernel"] == (32, 64)


def test_tensor_checkpoint_restores_on_one_rank(gang):
    """The ``tensor=2`` gang's checkpoint after three steps restored
    into a one-rank state: the fourth step's loss is the reference's."""
    refs, _ = gang
    state, step, mesh, batches, case = refs["pretrain-tensor2-checkpoints"]
    for batch in batches[:STEPS]:
        state, _ = step(state, jax.device_put(batch, batch_sharding(mesh)))
    _, want = step(state, jax.device_put(batches[STEPS],
                                         batch_sharding(mesh)))
    model = llama_test(dtype="float32")
    params = convert.params_from_flax(case["params"], model, device="cpu")
    one, _ = lm.create_lm_state(model, PORT_TXS[case["tx"]](), params)
    reader = ShardedCheckpointer(ContinuousCheckpointConfig(
        directory=case["save_dir"], async_save=False))
    one = reader.restore(one)
    reader.close()
    assert one.step == STEPS
    _, got = lm.make_lm_train_step()(one, batches[STEPS])
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=0, atol=LOSS_TOL)


def test_tpu_lm_on_a_tensor_gang_trains_as_one_rank_does(tmp_path):
    """``tpu-lm --mesh tensor=2`` in a two-process gang from the
    operator's env: both ranks read the same rows (one batch position)
    and their checkpoint, gathered to whole leaves, holds the params a
    one-process run of the same command reaches, within ``PARAM_TOL``."""
    from test_torch_launcher import GANG_PRETRAIN_PROCESS, _run_gang

    from kubeflow_tpu_torch.training.pretrain import main as pretrain_main

    args = ["--model", "llama-test", "--device", "cpu", "--steps", "2",
            "--global_batch", "4", "--seq_len", "16", "--save_every", "2"]
    results = _run_gang(*args, "--mesh", "tensor=2", "--checkpoint_dir",
                        str(tmp_path / "gang"), want_rc=0,
                        script=GANG_PRETRAIN_PROCESS)
    for r in results:
        assert r["rc"] == 0 and r["final_step"] == 2
        assert r["mesh"]["tensor"] == 2
    assert pretrain_main(args + ["--checkpoint_dir",
                                 str(tmp_path / "one")]) == 0
    read = {}
    for name in ("gang", "one"):
        reader = ShardedCheckpointer(ContinuousCheckpointConfig(
            directory=str(tmp_path / name), async_save=False))
        read[name] = convert.flatten_tree(reader.restore_raw(2))
        reader.close()
    params = [k for k in read["one"] if k.startswith("params/")]
    assert params and set(read["gang"]) == set(read["one"])
    for k in params:
        np.testing.assert_allclose(
            np.asarray(read["gang"][k], np.float64),
            np.asarray(read["one"][k], np.float64), rtol=PARAM_TOL,
            atol=PARAM_TOL, err_msg=k)
