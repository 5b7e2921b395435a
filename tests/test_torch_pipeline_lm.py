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

"""The pipeline LM trainer (``training/pipeline_lm.py``) in a 4-rank
gloo gang against the reference's, and ``tpu-lm --mesh pipeline=2`` in a
2-process gang against the reference's CLI.

Twins of the thirteen cases of ``tests/test_pipeline_lm.py``: the staged
forward against the reference's unpipelined model (one and two layers a
stage, under remat with finite gradients), the param partition, the GPipe step on
``data=2, pipeline=2`` and on ``pipeline=4`` and the interleaved step
(v = 2), each against the reference's pipeline step at its own mesh
(the first step's loss and grad norm; ``adamw(5e-3)``: eleven steps
whose loss falls), the bubble formulas and the refused blocks.
Both sides start from the reference's init, carried across; each rank
feeds its rows of the same numpy batches. Tolerances: logits within the
reference's 2e-4; each step's loss within 1e-4 of the reference
pipeline step's, and its grad norm within 1e-4 over the first two steps
(1e-3 after them, where adamw(5e-3) has grown the fp32 rounding); the
trained state within 5e-4. Also: a
checkpoint written by the gang's ranks (each its host shard, its own
stages) restores into a fresh state bitwise and the run goes on as the
uninterrupted run; the CLI's losses over 3 steps within 1e-4 of the
reference CLI's, GPipe and interleaved.
"""

import concurrent.futures
import dataclasses
import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from _torch_gang import run_gang
from _torch_training import flat
from kubeflow_tpu.models.llama import Llama as JaxLlama
from kubeflow_tpu.parallel.mesh import MeshSpec, build_mesh
from kubeflow_tpu.training.lm import place_lm_batch
from kubeflow_tpu.parallel.pipeline import (
    interleave_stage_params as jax_interleave,
)
from kubeflow_tpu.training.pipeline_lm import (
    PipelineLMState,
    make_pipeline_lm_train_step as jax_step,
    partition_llama_params as jax_partition,
    pipeline_state_shardings as jax_shardings,
)
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.llama import Llama, llama_test
from kubeflow_tpu_torch.parallel.pipeline import (
    bubble_fraction,
    bubble_fraction_interleaved,
)
from kubeflow_tpu_torch.training.checkpoint import (
    ContinuousCheckpointConfig,
    ShardedCheckpointer,
)
from kubeflow_tpu_torch.training.pipeline_lm import (
    _block_for,
    partition_llama_params,
)

VOCAB = 512
LOGIT_TOL = 2e-4
STEP_RTOL = 1e-4
PARAM_TOL = 5e-4
#: The grad norm after three adamw(5e-3) steps (STEP_RTOL up to then):
#: fp32 sums in another order than XLA's, grown by the steps (at most
#: 4.6e-4 seen, in the 2-layer GPipe run's step 4; its losses stay
#: within 1.5e-5).
TRAINED_NORM_RTOL = 1e-3
CLI_STEPS = 3


def model_kwargs(layers=2, **kw):
    return dict(vocab_size=VOCAB, num_layers=layers, d_model=64,
                num_heads=4, num_kv_heads=2, mlp_dim=128, **kw)


def _batch(rows=8, length=16, seed=0):
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(0, VOCAB, (rows, length)).astype(
        np.int32)}


def reference_init(seed):
    """The reference's init of the 4-layer model from ``PRNGKey(seed)``,
    and the 2-layer one's: Flax keys each param's draw by its path, so
    the 2-layer tree is the 4-layer tree without layers 2 and 3."""
    model = JaxLlama(**model_kwargs(4), dtype="float32")
    ids = jnp.asarray(_batch(rows=4, length=8)["input_ids"])
    four = nn.meta.unbox(jax.jit(model.init)(jax.random.PRNGKey(seed),
                                             ids)["params"])
    return {4: four, 2: {k: v for k, v in four.items()
                         if k not in ("layer_2", "layer_3")}}


@pytest.fixture(scope="module")
def init():
    """The reference's fp32 inits of 2 and 4 layers."""
    return reference_init(0)


def forward_case(name, init, layers, n_stages, mesh_spec, rows, length,
                 remat=False):
    """(thunk of the reference model's unpipelined logits, which its own
    test holds its staged forward to within 2e-4; the port's case)."""
    params = init[layers]
    ids = _batch(rows=rows, length=length)["input_ids"]

    def run():
        model = JaxLlama(**model_kwargs(layers), dtype="float32",
                         remat=remat)
        return np.asarray(jax.jit(model.apply)({"params": params}, ids))
    return run, {"name": name, "kind": "forward", "spec": mesh_spec,
                 "kwargs": model_kwargs(layers, dtype="float32",
                                        remat=remat),
                 "params": flat(params), "stages": n_stages, "n_micro": 2,
                 "ids": ids}


def train_case(name, init, layers, n_stages, n_virtual, n_micro, tx_name,
               steps, rows, mesh_spec, save=None):
    """(thunk of the reference's pipeline step metrics, the port's
    case)."""
    params = init[layers]
    batch = _batch(rows=rows, length=16)
    tx = {"adamw5e-3": lambda: optax.adamw(5e-3)}[tx_name]

    def run():
        model = JaxLlama(**model_kwargs(layers), dtype="float32")
        mesh = build_mesh(MeshSpec(data=2, pipeline=n_stages),
                          jax.devices()[:2 * n_stages])
        # The state create_pipeline_lm_state builds from this init.
        staged = jax_partition(params, n_stages * n_virtual)
        if n_virtual > 1:
            staged["stages"] = jax_interleave(staged["stages"], n_stages)
        state = PipelineLMState(step=jnp.zeros((), jnp.int32),
                                params=staged, opt_state=tx().init(staged),
                                tx=tx())
        sh = jax_shardings(mesh, state, n_virtual)
        state = jax.device_put(state, sh)
        step = jax_step(mesh, sh, model, n_microbatches=n_micro,
                        donate=False, n_virtual=n_virtual)
        placed = place_lm_batch(mesh, batch)
        metrics = []
        for _ in range(steps):
            state, m = step(state, placed)
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, {k: np.asarray(v) for k, v in flat(
            {"params": state.params}).items()}
    case = {"name": name, "kind": "train", "spec": mesh_spec,
            "kwargs": model_kwargs(layers, dtype="float32"),
            "params": flat(params), "n_virtual": n_virtual,
            "n_micro": n_micro, "tx": tx_name, "batches": [batch] * steps}
    if save is not None:
        case.update(save_dir=save, save_at=steps // 2)
    return run, case


@pytest.fixture(scope="module")
def gang(init, tmp_path_factory):
    pp = {"data": 2, "pipeline": 2}
    pp4 = {"pipeline": 4}
    ckpt = str(tmp_path_factory.mktemp("pipeline-ckpt"))
    specs = {
        "forward": forward_case("forward", init, 2, 2, pp, 8, 16),
        "forward-4layers": forward_case("forward-4layers", init, 4, 2, pp,
                                        4, 8),
        "forward-remat": forward_case("forward-remat", init, 2, 2, pp, 4, 8,
                                      remat=True),
        "gpipe-train": train_case("gpipe-train", init, 2, 2, 1, 2,
                                  "adamw5e-3", 11, 8, pp, save=ckpt),
        "four-stage-train": train_case("four-stage-train", init, 4, 4, 1,
                                       4, "adamw5e-3", 11, 16, pp4),
        "interleaved-train": train_case("interleaved-train", init, 4, 2, 2,
                                        4, "adamw5e-3", 11, 16, pp),
    }
    cases = [case for _, case in specs.values()]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_gang, "pipeline_lm", cases,
                            tmp_path_factory.mktemp("gang-pipeline-lm"),
                            world=4, timeout=400.0)
        refs = {name: run() for name, (run, _) in specs.items()}
        return refs, {n: c for n, (_, c) in specs.items()}, ranks.result()


@pytest.mark.parametrize("name", ["forward", "forward-4layers",
                                  "forward-remat"])
def test_staged_forward_matches_the_reference(gang, name):
    refs, cases, ranks = gang
    want = refs[name]
    rows = want.shape[0] // 2
    for r, res in enumerate(ranks):
        # Each rank's rows of the data axis (data is outer to pipeline).
        pos = r // 2
        np.testing.assert_allclose(res[name]["logits"],
                                   want[pos * rows:(pos + 1) * rows],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=f"rank {r}")
        assert res[name]["finite"]


@pytest.mark.parametrize("name", ["gpipe-loss", "four-stage-loss",
                                  "interleaved-loss"])
def test_pipeline_step_matches_the_reference_loss(gang, name):
    """The first step's loss and grad norm, the reference pipeline step's
    (which its own test holds to the unpipelined step's, with
    ``sgd(0)``): no optimizer enters them, so they are the adamw runs'
    first step."""
    refs, cases, ranks = gang
    run = name.replace("-loss", "-train")
    want, _ = refs[run]
    for r, res in enumerate(ranks):
        got = res[run]["metrics"][0]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[0][k], rtol=STEP_RTOL,
                                       err_msg=f"rank {r}")


@pytest.mark.parametrize("name", ["gpipe-train", "four-stage-train",
                                  "interleaved-train"])
def test_pipeline_training_matches_the_reference_and_learns(gang, name):
    refs, cases, ranks = gang
    want, want_params = refs[name]
    for r, res in enumerate(ranks):
        got = [m for m in res[name]["metrics"] if "loss" in m]
        assert len(got) == len(want) == 11
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=STEP_RTOL,
                                       err_msg=f"rank {r} step {i} loss")
            np.testing.assert_allclose(
                g["grad_norm"], w["grad_norm"],
                rtol=STEP_RTOL if i < 3 else TRAINED_NORM_RTOL,
                err_msg=f"rank {r} step {i} grad_norm")
        assert got[-1]["loss"] < got[0]["loss"]
        state = {k: v for k, v in res[name]["state"].items()
                 if k.startswith("params/")}
        assert set(state) == set(want_params)
        for k, v in want_params.items():
            np.testing.assert_allclose(
                np.asarray(state[k], np.float64), np.asarray(v, np.float64),
                rtol=PARAM_TOL, atol=PARAM_TOL, err_msg=f"rank {r} {k}")


def test_each_rank_holds_only_its_stages(gang):
    _, cases, ranks = gang
    for name, lead in (("gpipe-train", (1, 1)), ("four-stage-train", (1, 1)),
                       ("interleaved-train", (2, 1, 1))):
        for res in ranks:
            pieces = res[name]["pieces"]
            stage = pieces["stages.attention.q_proj.weight"]
            assert stage[:len(lead)] == lead, (name, stage)
            assert pieces["tok_embed.weight"] == (VOCAB, 64)


def test_pipeline_checkpoint_resumes_bitwise(gang):
    """Halfway through the GPipe run on ``data=2, pipeline=2`` the state
    (each rank's stages gathered over the pipeline line) is written as
    four host shards, and a fresh state restores it: every leaf bitwise,
    the step, and the rest of the run the reference's uninterrupted run
    (``test_pipeline_training_matches_the_reference_and_learns``)."""
    _, cases, ranks = gang
    case = cases["gpipe-train"]
    step_dir = os.path.join(case["save_dir"],
                            f"step-{case['save_at']:08d}")
    files = sorted(os.listdir(step_dir))
    assert files == ["manifest.json"] + [
        f"state.shard-{i:05d}-of-00004.msgpack" for i in range(4)]
    manifest = json.load(open(os.path.join(step_dir, "manifest.json")))
    assert manifest["num_hosts"] == 4
    for res in ranks:
        marker = [m for m in res["gpipe-train"]["metrics"]
                  if "restored_bitwise" in m]
        assert marker == [{"restored_bitwise": True,
                           "restored_step": case["save_at"]}]
    # The checkpoint holds the reference's staged tree.
    reader = ShardedCheckpointer(ContinuousCheckpointConfig(
        directory=case["save_dir"], async_save=False))
    restored = convert.flatten_tree(reader.restore_raw(case["save_at"]))
    reader.close()
    assert restored["params/stages/attention/q_proj/kernel"].shape == (
        2, 1, 64, 64)
    assert restored["params/stages/attention/k_proj/kernel"].shape == (
        2, 1, 64, 32)


def test_partition_llama_params_validates():
    model = llama_test(dtype="float32")
    params = convert.init_params(model, seed=0, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        partition_llama_params(params, 3)
    staged = partition_llama_params(params, 2)
    leaf = staged["stages.attention.q_proj.weight"]
    assert leaf.shape[:2] == (2, 1)
    assert set(staged) >= {"tok_embed.weight", "final_norm.scale",
                           "lm_head.weight"}


def test_bubble_fraction_interleaved_formula():
    for n, m in ((4, 4), (4, 16), (8, 32)):
        assert bubble_fraction_interleaved(n, m, 1) == pytest.approx(
            bubble_fraction(n, m))
    assert bubble_fraction_interleaved(4, 8, 2) == pytest.approx(3 / 19)
    assert bubble_fraction_interleaved(4, 8, 2) < bubble_fraction(4, 8)
    assert bubble_fraction_interleaved(4, 8, 4) == pytest.approx(3 / 35)
    assert bubble_fraction_interleaved(1, 8, 3) == 0.0
    with pytest.raises(ValueError):
        bubble_fraction_interleaved(4, 4, 0)


def test_bubble_fraction_formula():
    assert bubble_fraction(1, 1) == 0.0
    assert bubble_fraction(1, 64) == 0.0
    assert bubble_fraction(4, 4) == pytest.approx(3 / 7)
    assert bubble_fraction(4, 16) == pytest.approx(3 / 19)
    assert bubble_fraction(8, 32) == pytest.approx(7 / 39)
    assert bubble_fraction(4, 9 * 3 + 1) < 0.10
    with pytest.raises(ValueError):
        bubble_fraction(0, 4)
    with pytest.raises(ValueError):
        bubble_fraction(4, 0)


@pytest.mark.parametrize("kw", [{"lora_rank": 4}, {"num_experts": 4},
                                {"cache_size": 32}])
def test_pipeline_rejects_unsupported_blocks(kw):
    with pytest.raises(ValueError, match="dense training blocks"):
        _block_for(llama_test(**kw))


# -- tpu-lm --mesh pipeline=2 --------------------------------------------------

CLI_ARGS = ["--model", "llama-test", "--global_batch", "8", "--seq_len",
            "16", "--steps", str(CLI_STEPS), "--log_every", "1",
            "--microbatches", "2", "--seed", "3"]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """``tpu-lm --mesh pipeline=2`` in one 2-process gang, GPipe at
    ``llama-test`` and ``--virtual_stages 2`` at ``llama-test`` cut to 4
    layers (``--num_layers 4``; one layer a virtual stage), each from
    the reference CLI's init (``PRNGKey(seed)`` over its stream's first
    batch) carried across; meanwhile the reference's CLI on ``data=4,
    pipeline=2`` (its registry entry made 4 deep for the second run).
    Returns ({virtual: the reference's losses}, the gang's results)."""
    from kubeflow_tpu.models import registry as jax_registry
    from kubeflow_tpu.models.registry import get_model as jax_get_model
    from kubeflow_tpu.training.pretrain import main as jax_pretrain_main

    base = tmp_path_factory.mktemp("pipeline-cli")
    entries = {1: jax_get_model("llama-test"),
               2: dataclasses.replace(
                   jax_get_model("llama-test"),
                   make=lambda **kw: JaxLlama(**model_kwargs(4), **kw))}
    # The reference CLI draws from PRNGKey(seed) (the draw does not
    # depend on the batch it traces or the compute dtype).
    inits = reference_init(3)
    cases = []
    for virtual, entry in entries.items():
        params = inits[4 if virtual > 1 else 2]
        out = base / f"v{virtual}"
        out.mkdir()
        extra = ["--virtual_stages", str(virtual)] + (
            ["--num_layers", "4"] if virtual > 1 else [])
        cases.append({"name": f"v{virtual}", "spec": {"pipeline": 2},
                      "params": convert.flatten_tree(params),
                      "out": str(out),
                      "argv": CLI_ARGS + extra + [
                          "--mesh", "pipeline=2", "--device", "cpu"]})
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_gang, "cli", cases, base / "gang", world=2)
        refs = {}
        with pytest.MonkeyPatch.context() as mp:
            for virtual, entry in entries.items():
                mp.setitem(jax_registry._MODELS, "llama-test", entry)
                path = base / f"ref{virtual}.jsonl"
                jax_pretrain_main(CLI_ARGS + [
                    "--virtual_stages", str(virtual), "--mesh",
                    "data=4,pipeline=2", "--metrics_path", str(path)])
                refs[virtual] = [json.loads(x)["loss"] for x in
                                 path.read_text().split("\n") if x.strip()]
        return refs, ranks.result()


@pytest.mark.parametrize("virtual", [1, 2])
def test_tpu_lm_pipeline_gang_matches_the_reference_cli(cli, virtual):
    """``tpu-lm --mesh pipeline=2`` as a 2-process gang against the
    reference's CLI on ``data=4, pipeline=2`` (the ``cli`` fixture):
    each step's loss is the reference's within 1e-4."""
    refs, ranks = cli
    want = refs[virtual]
    assert len(want) == CLI_STEPS
    for r, res in enumerate(ranks):
        got = res[f"v{virtual}"]
        assert got["rc"] == 0 and got["final"]["final_step"] == CLI_STEPS
        assert got["final"]["mesh"]["pipeline"] == 2
        losses = [m["loss"] for m in got["metrics"]]
        np.testing.assert_allclose(losses, want, rtol=STEP_RTOL,
                                   err_msg=f"rank {r}")


def test_tpu_lm_pipeline_refuses_a_non_decoder():
    from kubeflow_tpu_torch.training.pretrain import main

    with pytest.raises(SystemExit, match="causal decoder"):
        main(["--model", "bert-test", "--steps", "1", "--device", "cpu",
              "--mesh", "pipeline=2"])


def test_pipeline_forward_raises_on_a_tensor_model():
    from kubeflow_tpu_torch.parallel.mesh import Mesh, MeshSpec as PortSpec

    model = Llama(**model_kwargs(2), dtype="float32",
                  mesh=Mesh(PortSpec(tensor=2), device="cpu"))
    with pytest.raises(ValueError, match="without a tensor axis"):
        _block_for(model)
