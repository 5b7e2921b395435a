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

"""The port's expert axis in one 4-rank gloo gang against the reference.

- The MoE layer built on a mesh (``ops/moe.py`` ``MoE(mesh=)``) on
  ``data=2, expert=2`` and ``expert=2, tensor=2`` against the reference's
  single-device ``MoE`` (the twin of ``tests/test_moe.py::
  test_moe_expert_parallel_matches_single_device``): the output within
  2e-5, the aux loss the global batch's, and the router, ``w_in`` and
  ``w_out`` gradients within 5e-4, for a routing group that straddles
  the two data ranks and for groups that do not.
- ``llama-moe-test`` LM steps against the reference's ``create_lm_state``
  and ``make_lm_train_step`` on the same meshes over 4 of its CPU
  devices (the twin of ``tests/test_moe.py::test_llama_moe_trains``):
  ``data=2, expert=2`` (its groups straddle the data ranks),
  ``expert=2, tensor=2``, and ``data=2, expert=2`` with two
  microbatches a step. Held: the loss within 1e-5 a step, the grad norm
  within 1e-4, the state within 5e-4 after three steps, the ranks'
  metrics equal, the aux metric the reference's, and each rank's
  ``w_in`` piece the reference's shard for its device.
- Host-sharded checkpoints of the expert- and tensor-split state cross
  the packages both ways bit-equal: the reference's checkpoint of its
  init restores into the ranks' pieces, and the gang's after three
  steps into the reference's state, whose next loss is the gang's within
  1e-5.
- ``tpu-lm --mesh data=2,expert=2`` on ``llama-moe-test`` and on the
  dense ``llama-test`` (``expert`` a replicated axis there) against the
  reference CLI on ``data=4, expert=2``.
"""

import concurrent.futures
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from _torch_gang import run_gang
from _torch_training import VOCAB, flat, reference_flat_state
from kubeflow_tpu.models.registry import get_model as jax_get_model
from kubeflow_tpu.ops.moe import MoE as JaxMoE
from kubeflow_tpu.parallel.mesh import MeshSpec, batch_sharding, build_mesh
from kubeflow_tpu.training import checkpoint as jckpt
from kubeflow_tpu.training import lm as jlm
from kubeflow_tpu_torch.models import convert

OUT_TOL = 2e-5
GRAD_TOL = 5e-4
LOSS_TOL = 1e-5
NORM_RTOL = 1e-4
STATE_TOL = 5e-4
STEPS = 3

#: name → (mesh sizes, tokens [B, S], group size).
MOE_CASES = {
    "moe-data2-expert2-straddle": ({"data": 2, "expert": 2}, (4, 8), 512),
    "moe-data2-expert2-grouped": ({"data": 2, "expert": 2}, (4, 8), 8),
    "moe-expert2-tensor2": ({"expert": 2, "tensor": 2}, (4, 8), 8),
}
MOE_KW = {"num_experts": 4, "mlp_dim": 32, "num_selected": 2}

#: name → (mesh sizes, batch rows, seq len, optimizer, grad_accum).
LM_CASES = {
    "lm-data2-expert2": ({"data": 2, "expert": 2}, 4, 32, "adamw", 1),
    "lm-expert2-tensor2": ({"expert": 2, "tensor": 2}, 4, 32,
                           "pretrain_chain", 1),
    "lm-data2-expert2-accum2": ({"data": 2, "expert": 2}, 32, 64, "adamw",
                                2),
}
CROSSING = "lm-expert2-tensor2"

TXS = {
    "adamw": lambda: optax.adamw(1e-3),
    "pretrain_chain": lambda: optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adamw(optax.schedules.warmup_cosine_decay_schedule(
            0.0, 1e-3, 2, 10), weight_decay=0.01)),
}

CLI_ARGS = ["--global_batch", "8", "--seq_len", "16", "--steps", "2",
            "--log_every", "1"]
CLI_MODELS = ("llama-moe-test", "llama-test")


def moe_reference(name):
    """The reference's single-device layer: (case, its output, aux and
    gradients of ``sum(out²) + 0.01·aux``)."""
    spec, (b, s), group = MOE_CASES[name]
    moe = JaxMoE(group_size=group, dtype=jnp.float32, **MOE_KW)
    x = np.random.default_rng(4).normal(size=(b, s, 16)).astype(np.float32)
    params = nn.meta.unbox(jax.jit(moe.init)(jax.random.PRNGKey(5),
                                             x))["params"]

    def loss(p):
        out, state = moe.apply({"params": p}, x, mutable=["losses"])
        aux = state["losses"]["moe_aux"][0]
        return jnp.sum(out ** 2) + 0.01 * aux, (out, aux)

    (_, (out, aux)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    case = {"name": name, "spec": spec, "x": x,
            "kwargs": dict(MOE_KW, d_model=16, group_size=group),
            "router": np.asarray(params["router"]["kernel"]),
            "w_in": np.asarray(params["w_in"]),
            "w_out": np.asarray(params["w_out"])}
    return case, np.asarray(out), float(aux), {
        "router": np.asarray(grads["router"]["kernel"]),
        "w_in": np.asarray(grads["w_in"]),
        "w_out": np.asarray(grads["w_out"])}


def causal_batches(seed, b, l, steps):
    """Padded causal rows (the loss's token count differs by row)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ids = rng.integers(0, VOCAB, (b, l)).astype(np.int32)
        w = np.ones((b, l), np.float32)
        w[b // 2:, l // 2:] = 0.0
        out.append({"input_ids": ids, "loss_weights": w})
    return out


def lm_reference(name, tmp):
    """(reference state, step, mesh, batches, the port's case)."""
    spec, b, l, tx, accum = LM_CASES[name]
    devices = jax.devices()[:int(np.prod(list(spec.values())))]
    mesh = build_mesh(MeshSpec(**spec), devices)
    model = jax_get_model("llama-moe-test").make(dtype=jnp.float32)
    batches = causal_batches(7, b, l, STEPS + 1)
    state, sh = jlm.create_lm_state(model, TXS[tx](), jax.random.PRNGKey(2),
                                    batches[0], mesh)
    step = jlm.make_lm_train_step(mesh, sh, donate=False, grad_accum=accum)
    case = {"name": name, "job": "lm", "spec": spec, "env": {},
            "objective": "causal", "model": "llama-moe-test",
            "kwargs": {"dtype": "float32"}, "params": flat(state.params),
            "lora": None, "tx": tx, "grad_accum": accum,
            "batches": batches[:STEPS]}
    shards = {s.device.id: np.asarray(s.data)
              for s in state.params["layer_0"]["moe"]["w_in"]
              .addressable_shards}
    case["ref_w_in"] = [shards[d.id] for d in mesh.devices.flat]
    if name == CROSSING:
        # The reference's init through its own 4-host checkpoint, and
        # the gang's state after its steps into one of the gang's.
        gang = [jckpt.ShardedCheckpointer(jckpt.ContinuousCheckpointConfig(
            directory=str(tmp / "ref-init"), num_hosts=4, host_id=h,
            commit_timeout_seconds=30.0)) for h in range(4)]
        for writer in gang:
            assert writer.save(0, state, force=True)
        for writer in gang:
            assert writer.wait(30.0)
            writer.close()
        assert list((tmp / "ref-init").glob(f"step-*/{jckpt.MANIFEST_FILE}"))
        case.update(restore_dir=str(tmp / "ref-init"),
                    save_dir=str(tmp / "gang-after"), save_at=STEPS,
                    batches=batches)
    return state, step, mesh, batches, case


def reference_cli(name, base):
    """The reference CLI on ``data=4, expert=2``: its per-step metrics
    and final line, and its init (``PRNGKey(0)`` over its stream's first
    batch) for the gang to start from."""
    import contextlib
    import io

    from kubeflow_tpu.training.pretrain import main as jax_pretrain_main

    path = base / f"ref-{name}.jsonl"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_pretrain_main(CLI_ARGS + [
            "--model", name, "--mesh", "data=4,expert=2",
            "--metrics_path", str(path)]) == 0
    final = json.loads(out.getvalue().strip().splitlines()[-1])
    lines = [json.loads(x) for x in path.read_text().splitlines()
             if x.strip()]
    return final, lines


def cli_init(name):
    """The reference CLI's init of ``name``, as its create_lm_state draws
    it (the values do not depend on the mesh or the traced batch)."""
    model = jax_get_model(name).make()
    init = jax.jit(lambda r: model.init(r, jnp.zeros((1, 16), jnp.int32)))
    return convert.flatten_tree(nn.meta.unbox(
        init(jax.random.PRNGKey(0)))["params"])


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The reference's results and the gang's, by case name (the gang's
    a list over ranks)."""
    tmp = tmp_path_factory.mktemp("expert")
    moe = {n: moe_reference(n) for n in MOE_CASES}
    lms = {n: lm_reference(n, tmp) for n in LM_CASES}
    cases = [dict(r[0], job="moe") for r in moe.values()]
    cases += [r[4] for r in lms.values()]
    for name in CLI_MODELS:
        out = tmp / f"cli-{name}"
        out.mkdir()
        cases.append({"name": f"cli-{name}", "job": "cli",
                      "params": cli_init(name), "out": str(out),
                      "argv": CLI_ARGS + ["--model", name, "--mesh",
                                          "data=2,expert=2", "--device",
                                          "cpu"]})
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_gang, "lm", cases, tmp / "gang", world=4,
                            timeout=400.0)
        cli = {n: reference_cli(n, tmp) for n in CLI_MODELS}
        ran = {}
        for name, (state, step, mesh, batches, case) in lms.items():
            metrics = []
            for batch in batches[:STEPS]:
                state, m = step(state, jax.device_put(batch,
                                                      batch_sharding(mesh)))
                metrics.append({k: float(v) for k, v in m.items()})
            ran[name] = (state, metrics)
        results = ranks.result()
    by_case = {c["name"]: [r[c["name"]] for r in results] for c in cases}
    return moe, lms, ran, cli, by_case


@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_layer_on_a_mesh_matches_one_device(gang, name):
    moe, _, _, _, results = gang
    case, out, aux, grads = moe[name]
    ranks = results[name]
    b = case["x"].shape[0]
    data = case["spec"].get("data", 1)
    for r, res in enumerate(ranks):
        rows = b // data
        pos = (r // 2) if data > 1 else 0
        np.testing.assert_allclose(res["out"], out[pos * rows:][:rows],
                                   rtol=OUT_TOL, atol=OUT_TOL,
                                   err_msg=f"rank {r}")
        # The global batch's load-balance loss on every rank.
        np.testing.assert_allclose(res["aux"], aux, rtol=OUT_TOL)
        np.testing.assert_allclose(res["grads"]["router.weight"],
                                   grads["router"].T, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"rank {r}")
        experts = res["pieces"]["w_in"][0]
        e0 = (r % 2 if "expert" in case["spec"] and data > 1
              else r // 2) * experts
        width = res["pieces"]["w_in"][2]
        t = r % 2 if "tensor" in case["spec"] else 0
        f = slice(t * width, (t + 1) * width)
        np.testing.assert_allclose(
            res["grads"]["w_in"], grads["w_in"][e0:e0 + experts, :, f],
            rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(
            res["grads"]["w_out"], grads["w_out"][e0:e0 + experts, f],
            rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"rank {r}")
    assert ranks[0]["pieces"]["w_in"][0] == MOE_KW["num_experts"] // 2


def test_the_straddling_group_holds_rows_of_both_data_ranks(gang):
    """The straddling case's one routing group is the global batch's 32
    tokens, of which each data rank holds 16; the grouped case's groups
    of 8 lie within a rank."""
    moe, _, _, _, _ = gang
    from kubeflow_tpu.ops.moe import _fit_group_size

    for name, local in (("moe-data2-expert2-straddle", 16),
                        ("moe-data2-expert2-grouped", 16)):
        group = _fit_group_size(32, MOE_CASES[name][2])
        assert (local % group != 0) == name.endswith("straddle")


@pytest.mark.parametrize("name", sorted(LM_CASES))
def test_moe_lm_steps_match_the_reference_mesh(gang, name):
    _, lms, ran, _, results = gang
    _, _, mesh, _, case = lms[name]
    state, want = ran[name]
    ranks = results[name]
    assert ranks[0]["mesh"] == {k: int(v) for k, v in mesh.shape.items()}
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
    for i in range(STEPS):
        got = ranks[0]["metrics"][i]
        np.testing.assert_allclose(got["loss"], want[i]["loss"], rtol=0,
                                   atol=LOSS_TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(got["aux_loss"], want[i]["aux_loss"],
                                   rtol=0, atol=LOSS_TOL,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(got["grad_norm"], want[i]["grad_norm"],
                                   rtol=NORM_RTOL, err_msg=f"step {i}")
    ref = reference_flat_state(state, ("step", "params", "opt_state"))
    for r, res in enumerate(ranks):
        port = {k: v for k, v in res["state"].items()
                if k.split("/")[0] in ("step", "params", "opt_state")}
        assert set(port) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(
                np.asarray(port[k], np.float64), np.asarray(v, np.float64),
                rtol=STATE_TOL, atol=STATE_TOL, err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("name", sorted(LM_CASES))
def test_each_rank_holds_the_reference_expert_shard(gang, name):
    """Rank r's ``w_in`` piece is the reference's shard on device r, and
    its specs split ``w_in`` and ``w_out`` over ``expert``."""
    _, lms, _, _, results = gang
    case = lms[name][4]
    for r, res in enumerate(results[name]):
        key = "layer_0/moe/w_in"
        np.testing.assert_array_equal(res["own"][key], case["ref_w_in"][r])
        assert res["specs"][key][0] == "expert"
        assert res["specs"]["layer_0/moe/w_out"][0] == "expert"
        assert res["specs"]["layer_0/moe/router/kernel"] in ((None, None),
                                                             (None,) * 2)
        assert res["pieces"]["layers.0.moe.w_in"][0] == 2


def test_expert_checkpoints_cross_the_packages_bit_equal(gang):
    """The reference's 4-host checkpoint of its expert- and tensor-split
    init restores into the gang's pieces bit-equal, and the gang's after
    three steps into the reference's state bit-equal, whose fourth step's
    loss is the gang's within 1e-5."""
    _, lms, _, _, results = gang
    state0, step, mesh, batches, case = lms[CROSSING]
    ranks = results[CROSSING]
    init = reference_flat_state(state0, ("step", "params", "opt_state"))
    for r, res in enumerate(ranks):
        for k, v in init.items():
            np.testing.assert_array_equal(np.asarray(res["restored"][k]),
                                          np.asarray(v), err_msg=f"{r} {k}")
    reader = jckpt.ShardedCheckpointer(jckpt.ContinuousCheckpointConfig(
        directory=case["save_dir"]))
    restored = reader.restore(state0)
    reader.close()
    got = reference_flat_state(restored, ("step", "params", "opt_state"))
    saved = ranks[0]["state"]
    assert set(got) <= set(saved)
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(saved[k]),
                                      err_msg=k)
    _, m = step(restored, jax.device_put(batches[STEPS],
                                         batch_sharding(mesh)))
    np.testing.assert_allclose(ranks[0]["metrics"][STEPS]["loss"],
                               float(m["loss"]), rtol=0, atol=LOSS_TOL)


@pytest.mark.parametrize("name", CLI_MODELS)
def test_tpu_lm_on_an_expert_mesh_matches_the_reference_cli(gang, name):
    """``tpu-lm --mesh data=2,expert=2`` against the reference's CLI on
    ``data=4, expert=2``: the final line's model, objective and step, and
    each step's loss and aux loss."""
    _, _, _, cli, results = gang
    final, lines = cli[name]
    for r, res in enumerate(results[f"cli-{name}"]):
        assert res["rc"] == 0
        got = res["final"]
        for field in ("model", "objective", "final_step"):
            assert got[field] == final[field], field
        assert got["mesh"]["expert"] == final["mesh"]["expert"] == 2
        assert len(res["metrics"]) == len(lines)
        for mine, want in zip(res["metrics"], lines):
            np.testing.assert_allclose(mine["loss"], want["loss"],
                                       rtol=NORM_RTOL, err_msg=f"rank {r}")
            np.testing.assert_allclose(mine["aux_loss"], want["aux_loss"],
                                       rtol=NORM_RTOL, atol=1e-7,
                                       err_msg=f"rank {r}")
