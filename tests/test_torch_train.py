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

"""kubeflow_tpu_torch's vision trainer vs kubeflow_tpu's, on the CPU.

Three train steps of ``resnet-test`` fp32 from the same variables and
batch through JAX ``make_train_step(None)`` with ``optax.sgd(0.1, 0.9,
nesterov=True)`` and through the port with ``torch.optim.SGD``: loss,
accuracy, ``grad_norm``, params and batch_stats within 1e-4 after the
first and the third step (fp32 sums in another order, carried through
two SGD updates). The images are 64², not the registry's 32²: at 32²
the last stage is 1×1, and BN over a handful of values per channel
with near-zero variance amplifies summation-order differences tenfold a
step — an ill-conditioned input, not a difference of semantics. The
benchmark, its CLI checks, the synthetic data and
``evaluate_vision`` are held to the reference too.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from kubeflow_tpu.models.resnet import resnet18ish as jax_resnet18ish
from kubeflow_tpu.training.data import synthetic_images as jax_synthetic
from kubeflow_tpu.training.evaluate import evaluate_vision as jax_evaluate
from kubeflow_tpu.training.train import (
    create_train_state as jax_create_train_state,
    make_train_step as jax_make_train_step,
)
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.parallel.mesh import Mesh, MeshSpec
from kubeflow_tpu_torch.training import benchmark
from kubeflow_tpu_torch.training.data import synthetic_images
from kubeflow_tpu_torch.training.evaluate import evaluate_vision
from kubeflow_tpu_torch.training.train import (
    create_train_state,
    make_train_step,
    sgd,
)
from kubeflow_tpu_torch.utils.profile import summarize_trace

TOL = dict(atol=1e-4, rtol=1e-4)
STEPS = 3


def _flat(tree):
    return {k: np.array(v) for k, v in flatten_dict(tree, sep="/").items()}


def _batch(seed=0, n=16, size=64):
    rng = np.random.RandomState(seed)
    return {"inputs": rng.randn(n, size, size, 3).astype(np.float32),
            "labels": rng.randint(0, 10, (n,)).astype(np.int32)}


@pytest.fixture(scope="module", params=[0, 4], ids=["exact_bn", "stat_rows4"])
def trajectories(request):
    """(JAX, port) snapshots after steps 1..3: metrics, params, stats."""
    stat_rows = request.param
    batch = _batch()
    model = jax_resnet18ish(dtype=jnp.float32, bn_stat_rows=stat_rows)
    tx = optax.sgd(0.1, momentum=0.9, nesterov=True)
    state = jax.jit(lambda r: jax_create_train_state(
        model, tx, r, jnp.zeros((1, 64, 64, 3))))(jax.random.PRNGKey(0))
    params0, stats0 = _flat(state.params), _flat(state.batch_stats)
    step = jax_make_train_step(None, donate=False)
    jax_snaps = []
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(STEPS):
        state, metrics = step(state, jbatch)
        jax_snaps.append(({k: float(v) for k, v in metrics.items()},
                          _flat(state.params), _flat(state.batch_stats)))

    port_model = get_model("resnet-test").make(dtype="float32",
                                               bn_stat_rows=stat_rows)
    pstate = create_train_state(
        port_model, sgd(0.1, 0.9),
        convert.params_from_flax(params0, port_model, device="cpu"),
        convert.batch_stats_from_flax(stats0, port_model, device="cpu"))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pstep = make_train_step()
    port_snaps = []
    for _ in range(STEPS):
        pstate, metrics = pstep(pstate, tbatch)
        port_snaps.append((
            {k: float(v) for k, v in metrics.items()},
            {k: v.detach().numpy().copy() for k, v in pstate.params.items()},
            {k: v.numpy().copy() for k, v in pstate.batch_stats.items()}))
    assert pstate.step == STEPS
    return jax_snaps, port_snaps


@pytest.mark.parametrize("after", [1, STEPS])
def test_train_steps_match_the_reference(trajectories, after):
    jax_snaps, port_snaps = trajectories
    (jm, jp, js), (pm, pp, ps) = jax_snaps[after - 1], port_snaps[after - 1]
    for key in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(pm[key], jm[key], err_msg=key, **TOL)
    for name, value in pp.items():
        ref = jp[convert._flax_key(name)]
        if ref.ndim == 4:
            ref = ref.transpose(3, 2, 0, 1)
        elif ref.ndim == 2:
            ref = ref.T
        np.testing.assert_allclose(value, ref, err_msg=name, **TOL)
    for name, value in ps.items():
        np.testing.assert_allclose(value, js[name.replace(".", "/")],
                                   err_msg=name, **TOL)


def test_learns_on_a_fixed_batch():
    # tests/test_engine.py's contract, on the port's own bf16 init: the
    # same batch three times, and the loss must fall.
    model = get_model("resnet-test").make()
    params, stats = convert.init_vision(model, seed=0, device="cpu")
    state = create_train_state(model, sgd(0.1, 0.9), params, stats)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(seed=1, n=8, size=32).items()}
    step = make_train_step()
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[2] < losses[0], losses
    # BN running statistics moved off their init (mean 0 / var 1).
    assert any(float(t.abs().max()) > 1e-6 for n, t in
               state.batch_stats.items() if n.endswith(".mean"))


def test_train_step_refuses_a_mesh():
    """The vision trainer runs ``tensor`` and ``expert`` as replicated
    axes, as the reference's does (a gang's run against it:
    tests/test_torch_tensor_bert.py; the batch axes:
    tests/test_torch_gang_vision.py), and refuses ``pipeline``."""
    assert callable(make_train_step(mesh=Mesh(MeshSpec(data=2, tensor=2))))
    assert callable(make_train_step(mesh=Mesh(MeshSpec(expert=2))))
    with pytest.raises(NotImplementedError, match="pipeline"):
        make_train_step(mesh=Mesh(MeshSpec(data=2, pipeline=2)))


#: The keys of kubeflow_tpu/training/benchmark.py run_benchmark's result
#: (``mfu_pct`` only on an accelerator whose peak is known).
JAX_RESULT_KEYS = {"model", "global_batch_size", "n_chips", "steps",
                   "images_per_sec", "images_per_sec_per_chip",
                   "step_time_ms", "compile_plus_warmup_s", "final_loss",
                   "flops_per_step"}


def test_run_benchmark_on_the_cpu_returns_the_reference_keys(tmp_path):
    result = benchmark.run_benchmark(benchmark.BenchConfig(
        model="resnet-test", batch_size=16, steps=2, warmup_steps=1,
        profile_dir=str(tmp_path / "prof")), device="cpu")
    assert JAX_RESULT_KEYS <= set(result)
    assert "mfu_pct" not in result  # no device peak on the CPU
    assert result["device"] == "cpu" and result["n_chips"] == 1
    assert result["images_per_sec"] > 0 and result["flops_per_step"] > 0
    assert len(result["losses"]) == 2
    assert result["final_loss"] == result["losses"][-1]
    assert (tmp_path / "prof" / "trace.json").exists()


@pytest.mark.parametrize("argv,match", [
    (["--model", "resnet-test", "--bn_stat_rows", "-1"], ">= 0"),
    (["--model", "llama-test", "--bn_stat_rows", "4"], "vision models"),
    (["--model", "llama-test", "--data", "shards"], "requires --lora_rank"),
    (["--model", "no-such-model"], "unknown model"),
])
def test_cli_validation(argv, match, capsys):
    with pytest.raises(SystemExit) as e:
        benchmark.main(argv)
    assert e.value.code == 2
    assert match in capsys.readouterr().err


def test_synthetic_images_are_the_reference_batches():
    ours = synthetic_images(4, (8, 8, 3), 10, seed=3, dtype="float32",
                            device="cpu")
    ref = jax_synthetic(4, (8, 8, 3), 10, seed=3, dtype="float32")
    for _ in range(2):
        a, b = next(ours), next(ref)
        np.testing.assert_array_equal(a["inputs"].numpy(),
                                      np.asarray(b["inputs"]))
        np.testing.assert_array_equal(a["labels"].numpy(), b["labels"])
    bf16 = next(synthetic_images(2, (4, 4, 3), seed=1, device="cpu"))
    ref16 = next(jax_synthetic(2, (4, 4, 3), seed=1))
    np.testing.assert_array_equal(bf16["inputs"].float().numpy(),
                                  np.asarray(ref16["inputs"], np.float32))


def test_evaluate_vision_matches_the_reference():
    model = jax_resnet18ish(dtype=jnp.float32)
    variables = jax.jit(lambda r: model.init(
        r, jnp.zeros((1, 32, 32, 3)), train=False))(jax.random.PRNGKey(2))
    # Running statistics off their init, so eval-mode BN is exercised.
    rng = np.random.RandomState(5)
    stats = {k: (rng.rand(*v.shape) + 0.5 if k.endswith("var")
                 else rng.randn(*v.shape) * 0.1).astype(np.float32)
             for k, v in _flat(variables["batch_stats"]).items()}
    params = _flat(variables["params"])
    jax_vars = {"params": variables["params"],
                "batch_stats": jax.tree_util.tree_map(
                    jnp.asarray, _unflatten(stats))}
    ref = jax_evaluate(model.apply, jax_vars,
                       jax_synthetic(6, (32, 32, 3), 10, seed=1,
                                     dtype="float32"), max_batches=2)
    port_model = get_model("resnet-test").make(dtype="float32")
    got = evaluate_vision(
        port_model,
        {"params": convert.params_from_flax(params, port_model, "cpu"),
         "batch_stats": convert.batch_stats_from_flax(stats, port_model,
                                                      "cpu")},
        synthetic_images(6, (32, 32, 3), 10, seed=1, dtype="float32",
                         device="cpu"), max_batches=2)
    assert got["examples"] == ref["examples"] == 12
    assert got["batches"] == ref["batches"] == 2
    np.testing.assert_allclose(got["loss"], ref["loss"], **TOL)
    assert got["accuracy"] == ref["accuracy"]
    with pytest.raises(ValueError, match="no examples"):
        evaluate_vision(port_model, {"params": {}, "batch_stats": {}},
                        iter(()))


def _unflatten(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def test_profile_summary_charges_kernels_to_their_annotation(tmp_path):
    # A Chrome trace as torch.profiler writes it: kernels inside a GPU
    # annotation span are charged to it, others classed by name; host
    # rows and the spans themselves are never summed.
    events = [
        {"ph": "X", "cat": "gpu_user_annotation",
         "name": "bn_backward_recompute", "ts": 100, "dur": 50},
        {"ph": "X", "cat": "gpu_user_annotation",
         "name": "Optimizer.step#SGD.step", "ts": 300, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "reduce_kernel", "ts": 110,
         "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "vectorized_add", "ts": 305,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "bn_train_forward_kernel<bf16, 8>",
         "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel",
         "name": "sm90_xmma_fprop_implicit_gemm_bf16", "ts": 40,
         "dur": 40},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 200,
         "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0,
         "dur": 999},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    summary = summarize_trace(str(path), wall_ms=0.2)
    assert summary["by_class_ms"] == pytest.approx({
        "bn_backward_recompute": 0.03, "optimizer": 0.01,
        "bn_forward_kernel": 0.02, "convolution": 0.04, "copy/cast": 0.01})
    assert summary["device_busy_ms"] == pytest.approx(0.11)
    assert summary["device_idle_share"] == pytest.approx(0.45)
    assert summary["kernel_launches"] == 5
