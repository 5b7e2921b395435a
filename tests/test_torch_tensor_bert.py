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

"""The tensor axis for BERT, and the vision trainer's model axes, in one
4-rank gloo gang against the reference.

- BERT mlm on ``data=2, tensor=2`` with padded rows (the twin of
  ``tests/test_lm.py::test_bert_mlm_train_step_sharded``): three steps
  from the reference's meshed init against its step on the same mesh
  over 4 of its CPU devices. Held: the loss within 1e-5 a step, the grad
  norm within 1e-4, the state within 5e-4 after the steps, the ranks'
  metrics equal, and each rank holding its heads (q/k/v and ``mlp_in``
  column pieces, ``out`` and ``mlp_out`` row pieces) and its vocab rows
  of the tied table, the biases and ``mlm_bias`` whole.
- ``tpu-lm --mesh data=2,tensor=2`` on ``bert-test`` (the twin of
  ``tests/test_pretrain.py::test_pretrain_bert_mlm_tiny``, on 4 ranks in
  place of 8) against the reference CLI on ``data=4, tensor=2``.
- A vocab that does not split over ``tensor=4`` raises in both packages.
- The vision trainer on ``data=2, tensor=2``: the reference's vision step
  runs ``vit-test`` there (``tensor`` a replicated axis: its trainer lays
  params out by fsdp alone), and the port's step is held to it.
"""

import concurrent.futures
import contextlib
import io
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from _torch_gang import run_gang
from _torch_training import VOCAB, flat, reference_flat_state
from kubeflow_tpu.models.bert import bert_test as jax_bert_test
from kubeflow_tpu.models.registry import get_model as jax_get_model
from kubeflow_tpu.parallel.mesh import MeshSpec, batch_sharding, build_mesh
from kubeflow_tpu.training import lm as jlm
from kubeflow_tpu.training import train as jtrain
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.bert import bert_test
from kubeflow_tpu_torch.parallel import mesh as pmesh

LOSS_TOL = 1e-5
NORM_RTOL = 1e-4
STATE_TOL = 5e-4
VISION_TOL = dict(atol=1e-4, rtol=1e-4)
STEPS = 3
SPEC = {"data": 2, "tensor": 2}
CLI_ARGS = ["--model", "bert-test", "--global_batch", "8", "--seq_len",
            "32", "--steps", "2", "--log_every", "1"]
#: The CLI's BERT computes in bf16 (both packages' default), so its
#: losses are held at the bf16 tolerance of the cross-package tests.
CLI_RTOL = 3e-2


def bert_batches(seed, b=8, l=32):
    """mlm batches with padded rows: the last half of the rows' keys past
    position 20 are invalid (the flash call's key mask), and their
    positions carry no mlm weight."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        valid = np.ones((b, l), np.int32)
        valid[b // 2:, 20:] = 0
        weights = ((rng.random((b, l)) < 0.3) & (valid > 0)).astype(np.int32)
        out.append({"input_ids": rng.integers(0, VOCAB, (b, l))
                    .astype(np.int32),
                    "type_ids": rng.integers(0, 2, (b, l)).astype(np.int32),
                    "valid": valid,
                    "mlm_labels": rng.integers(0, VOCAB, (b, l))
                    .astype(np.int32),
                    "mlm_weights": weights})
    return out


def bert_reference():
    mesh = build_mesh(MeshSpec(**SPEC), jax.devices()[:4])
    batches = bert_batches(3)
    state, sh = jlm.create_lm_state(jax_bert_test(dtype=jnp.float32),
                                    optax.adamw(1e-3), jax.random.PRNGKey(1),
                                    batches[0], mesh)
    step = jlm.make_lm_train_step(mesh, sh, objective="mlm", donate=False)
    case = {"name": "bert", "job": "lm", "spec": SPEC, "env": {},
            "objective": "mlm", "model": "bert-test",
            "kwargs": {"dtype": "float32"}, "params": flat(state.params),
            "lora": None, "tx": "adamw", "batches": batches}
    return state, step, mesh, case


def vit_reference():
    mesh = build_mesh(MeshSpec(**SPEC), jax.devices()[:4])
    model = jax_get_model("vit-test").make(dtype=jnp.float32)
    tx = optax.sgd(0.1, momentum=0.9, nesterov=True)
    state = jax.jit(lambda r: jtrain.create_train_state(
        model, tx, r, jnp.zeros((1, 32, 32, 3))))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(7)
    batches = [{"inputs": rng.randn(8, 32, 32, 3).astype(np.float32),
                "labels": rng.randint(0, 10, (8,)).astype(np.int32)}
               for _ in range(STEPS)]
    case = {"name": "vit", "job": "vision", "model": "vit-test",
            "kwargs": {"dtype": "float32"}, "spec": SPEC, "env": {},
            "lr": 0.1, "momentum": 0.9,
            "params": flat(nn.meta.unbox(state.params)),
            "batch_stats": None, "batches": batches}
    return (jtrain.place_state(mesh, state),
            jtrain.make_train_step(mesh, donate=False), mesh, case)


def cli_init():
    """The reference CLI's BERT init (``PRNGKey(0)``; the draw does not
    depend on the mesh or the batch it traces)."""
    model = jax_get_model("bert-test").make()
    ids = jnp.zeros((1, 32), jnp.int32)
    init = jax.jit(lambda r: model.init(r, ids, ids, ids))
    return convert.flatten_tree(nn.meta.unbox(
        init(jax.random.PRNGKey(0)))["params"])


def reference_cli(base):
    from kubeflow_tpu.training.pretrain import main as jax_pretrain_main

    path = base / "ref.jsonl"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_pretrain_main(CLI_ARGS + [
            "--mesh", "data=4,tensor=2", "--metrics_path", str(path)]) == 0
    final = json.loads(out.getvalue().strip().splitlines()[-1])
    return final, [json.loads(x) for x in path.read_text().splitlines()
                   if x.strip()]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor-bert")
    bert = bert_reference()
    vit = vit_reference()
    (tmp / "cli").mkdir()
    cases = [bert[3], vit[3],
             {"name": "cli", "job": "cli", "params": cli_init(),
              "out": str(tmp / "cli"),
              "argv": CLI_ARGS + ["--mesh", "data=2,tensor=2", "--device",
                                  "cpu"]}]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_gang, "lm", cases, tmp / "gang", world=4,
                            timeout=400.0)
        cli = reference_cli(tmp)
        ran = {}
        for name, (state, step, mesh, case) in (("bert", bert),
                                                ("vit", vit)):
            metrics = []
            for batch in case["batches"]:
                placed = (jax.device_put(batch, batch_sharding(mesh))
                          if name == "bert"
                          else jtrain.place_batch(mesh, batch))
                state, m = step(state, placed)
                metrics.append({k: float(v) for k, v in m.items()})
            ran[name] = (state, metrics)
        results = ranks.result()
    by_case = {c["name"]: [r[c["name"]] for r in results] for c in cases}
    return ran, cli, by_case


def test_bert_mlm_on_data2_tensor2_matches_the_reference_mesh(gang):
    ran, _, results = gang
    state, want = ran["bert"]
    ranks = results["bert"]
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
    for i in range(STEPS):
        got = ranks[0]["metrics"][i]
        np.testing.assert_allclose(got["loss"], want[i]["loss"], rtol=0,
                                   atol=LOSS_TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(got["accuracy"], want[i]["accuracy"],
                                   rtol=0, atol=LOSS_TOL)
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


def test_each_bert_rank_holds_its_heads_and_vocab_rows(gang):
    """q/k/v and ``mlp_in`` ([out, in] in the port) are split on their
    outputs, ``out`` and ``mlp_out`` on their inputs, the token table on
    its rows; every bias, ``mlm_bias``, ``mlm_transform`` and the norms
    are whole, as the reference's rule table keeps them."""
    _, _, results = gang
    res = results["bert"][0]
    specs, pieces = res["specs"], {convert.flax_key(k): v
                                   for k, v in res["pieces"].items()}
    for name in ("query", "key", "value"):
        key = f"layer_0/attention/{name}/kernel"
        assert specs[key] == ("tensor", None) and pieces[key] == (32, 64)
        assert specs[f"layer_0/attention/{name}/bias"] == (None,)
        assert pieces[f"layer_0/attention/{name}/bias"] == (64,)
    assert specs["layer_0/attention/out/kernel"] == (None, "tensor")
    assert pieces["layer_0/attention/out/kernel"] == (64, 32)
    assert pieces["layer_0/mlp_in/kernel"] == (64, 64)
    assert pieces["layer_0/mlp_out/kernel"] == (64, 64)
    assert pieces["tok_embed/embedding"] == (VOCAB // 2, 64)
    assert pieces["mlm_bias"] == (VOCAB,)
    assert pieces["mlm_transform/kernel"] == (64, 64)
    assert pieces["pos_embed/embedding"] == (128, 64)


def test_tpu_lm_bert_on_data2_tensor2_matches_the_reference_cli(gang):
    """``tpu-lm --mesh data=2,tensor=2`` on ``bert-test`` against the
    reference CLI on ``data=4, tensor=2``: the final line's model,
    objective and step, and each step's loss at the bf16 tolerance."""
    _, (final, lines), results = gang
    for r, res in enumerate(results["cli"]):
        assert res["rc"] == 0
        got = res["final"]
        for field in ("model", "objective", "final_step"):
            assert got[field] == final[field], field
        assert got["mesh"]["tensor"] == final["mesh"]["tensor"] == 2
        assert len(res["metrics"]) == len(lines)
        for mine, want in zip(res["metrics"], lines):
            np.testing.assert_allclose(mine["loss"], want["loss"],
                                       rtol=CLI_RTOL, err_msg=f"rank {r}")


def test_vision_tensor_is_a_replicated_axis_as_in_the_reference(gang):
    """The reference's vision step runs ``vit-test`` on ``data=2,
    tensor=2`` (params by fsdp alone, the batch over the data axes), and
    the port's step there is held to it: loss, accuracy and grad norm
    each step, the params after, every param whole on every rank."""
    ran, _, results = gang
    state, want = ran["vit"]
    ranks = results["vit"]
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
    for i in range(STEPS):
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(ranks[0]["metrics"][i][key],
                                       want[i][key], err_msg=f"{key} {i}",
                                       **VISION_TOL)
    ref = flat(nn.meta.unbox(state.params))
    for r, res in enumerate(ranks):
        assert set(res["params"]) == set(ref)
        for key, value in ref.items():
            np.testing.assert_allclose(res["params"][key], np.asarray(value),
                                       err_msg=f"rank {r} {key}",
                                       **VISION_TOL)


def test_a_vocab_that_does_not_split_over_tensor4_raises_in_both():
    """``vocab_size=510`` at ``tensor=4``: the reference's sharded init
    refuses the table (510 rows over 4), and so does the port's model
    built on the mesh, at every rank."""
    mesh = build_mesh(MeshSpec(tensor=4), jax.devices()[:4])
    ids = np.zeros((2, 16), np.int32)
    batch = {"input_ids": ids, "type_ids": ids, "valid": ids + 1,
             "mlm_labels": ids, "mlm_weights": ids}
    with pytest.raises(ValueError, match="divisible by 4"):
        jlm.create_lm_state(jax_bert_test(vocab_size=510), optax.adamw(1e-3),
                            jax.random.PRNGKey(0), batch, mesh)
    spec = pmesh.MeshSpec(tensor=4)
    for rank in range(4):
        with pytest.raises(ValueError, match="510 does not split"):
            bert_test(vocab_size=510, mesh=pmesh.Mesh(spec, rank=rank))
    # 512 splits: each rank's table is its quarter.
    model = bert_test(mesh=pmesh.Mesh(spec, rank=3))
    assert tuple(model.tok_embed.embedding.shape) == (128, 64)
    assert model.tok_embed.start == 384
