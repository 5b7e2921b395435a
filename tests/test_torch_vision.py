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

"""ViT, Inception-v3, VGG and AlexNet of the port against the reference.

Each model fp32, its variables carried across from the reference's
jitted init, the same numpy-seeded images through both. Tolerances:
logits 1e-4 (fp32 sums in another order); three SGD train steps (the
reference's ``make_train_step(None)`` and ``optax.sgd(lr, 0.9,
nesterov=True)`` at the registry's lr) 1e-4 in loss and params; served
``classify`` equal to the reference's ``load_version`` on the same
export within 1e-5 in scores, classes equal. Inception-v3 at 299² is
held to ``tests/golden/inception_v3_logits.json`` at that test's own
1e-3 (tests/test_inception_golden.py); its other cases run at 75², the
smallest input the net takes. There its train mode is held at 5e-3 in
the logits and 1e-3 in the running statistics: measured layer by layer,
the difference grows smoothly from 2e-6 at the stem to 3e-3 at mixed7c
(activations of magnitude 2.5–5), fp32 summation order carried through
94 train-mode BN layers whose last ones see 8 values a channel (as
tests/test_torch_train.py documents for ResNet at 32²). Twins of
tests/test_vit.py, tests/test_classic_cnn.py and
tests/test_inception_golden.py.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_training import flat, port_variables, reference_variables
from kubeflow_tpu.models.registry import get_model as get_jax_model
from kubeflow_tpu.serving.export import export_model as jax_export
from kubeflow_tpu.serving.model import load_version as jax_load_version
from kubeflow_tpu.serving.signature import ModelMetadata as JaxMetadata
from kubeflow_tpu.training.train import make_train_step as jax_train_step
from kubeflow_tpu.training.train import TrainState
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.layers import apply
from kubeflow_tpu_torch.models.registry import get_model, list_models
from kubeflow_tpu_torch.serving.export import export_model
from kubeflow_tpu_torch.serving.model import load_version
from kubeflow_tpu_torch.serving.signature import (
    ModelMetadata,
    Signature,
    TensorSpec,
)
from kubeflow_tpu_torch.training import benchmark
from kubeflow_tpu_torch.training.train import (
    create_train_state,
    make_train_step,
    sgd,
)

TOL = dict(atol=1e-4, rtol=1e-4)
SERVE_TOL = 1e-5
GOLDEN = Path(__file__).parent / "golden" / "inception_v3_logits.json"
PROBE_CLASSES = [0, 7, 42, 123, 256, 400, 512, 640, 777, 999]

# name → (image size, model kwargs of both packages)
CASES = {
    "vit-test": (32, {}),
    "vgg-test": (32, {}),
    "alexnet": (67, {"num_classes": 10}),
    "inception-v3": (75, {"num_classes": 10}),
}


def _images(seed, n, size):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _pair(name, seed=0):
    size, kw = CASES[name]
    ref, variables = reference_variables(
        name, [((1, size, size, 3), jnp.float32)], seed=seed,
        dtype=jnp.float32, **kw)
    port_kw = dict(kw, dtype="float32")
    if getattr(get_model(name).make(**port_kw), "SIZED_BY_IMAGE", False):
        port_kw["image_size"] = size
    model, params, stats = port_variables(name, variables, **port_kw)
    return ref, variables, model, params, stats


def test_every_reference_model_resolves_with_its_entry():
    from kubeflow_tpu.models.registry import list_models as jax_models

    ref = jax_models()
    port = list_models()
    assert sorted(port) == sorted(ref)
    for name, entry in ref.items():
        mine = port[name]
        assert (mine.family, mine.input_spec, mine.num_classes_or_vocab,
                mine.bench_lr, mine.decoder) == (
            entry.family, entry.input_spec, entry.num_classes_or_vocab,
            entry.bench_lr, entry.decoder), name


@pytest.mark.parametrize("name", sorted(CASES))
def test_eval_logits_match_the_reference(name):
    ref, variables, model, params, stats = _pair(name)
    x = _images(1, 3, CASES[name][0])
    want = np.asarray(jax.jit(lambda v, x: ref.apply(v, x, train=False))(
        variables, x))
    got = apply(model, params, stats, torch.from_numpy(x), train=False)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_inception_train_forward_and_batch_stats_match_the_reference():
    ref, variables, model, params, stats = _pair("inception-v3")
    x = _images(2, 8, 75)
    want, mutated = jax.jit(lambda v, x: ref.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    got = apply(model, params, stats, torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=5e-3, rtol=5e-3)
    for key, value in flat(mutated["batch_stats"]).items():
        np.testing.assert_allclose(stats[key.replace("/", ".")].numpy(),
                                   value, atol=1e-3, rtol=1e-3,
                                   err_msg=key)


def test_inception_v3_holds_the_golden_logits():
    """One 299² image through the port, fp32, from the reference's
    ``PRNGKey(0)`` init: the probe classes' logits at the golden test's
    tolerance."""
    ref, variables = reference_variables(
        "inception-v3", [((1, 299, 299, 3), jnp.float32)], seed=0,
        num_classes=1000, dtype=jnp.float32)
    model, params, stats = port_variables("inception-v3", variables,
                                          num_classes=1000, dtype="float32")
    image = (np.random.RandomState(42).randint(0, 256, (1, 299, 299, 3))
             / 255.0).astype(np.float32)
    logits = apply(model, params, stats, torch.from_numpy(image),
                   train=False).detach().numpy().astype(np.float64)[0]
    golden = json.loads(GOLDEN.read_text())
    assert golden["probe_classes"] == PROBE_CLASSES
    np.testing.assert_allclose(logits[PROBE_CLASSES], golden["logits"],
                               atol=1e-3)


def _trajectories(name, steps=3, n=8, seed=3):
    ref, variables, model, params, stats = _pair(name, seed=seed)
    size = CASES[name][0]
    lr = get_model(name).bench_lr or 0.1
    rng = np.random.RandomState(seed)
    batch = {"inputs": _images(seed, n, size),
             "labels": rng.randint(0, 10, (n,)).astype(np.int32)}
    tx = optax.sgd(lr, momentum=0.9, nesterov=True)
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       opt_state=tx.init(variables["params"]),
                       batch_stats=variables.get("batch_stats"),
                       apply_fn=ref.apply, tx=tx)
    jstep = jax_train_step(None, donate=False)
    pstate = create_train_state(model, sgd(lr, 0.9), params, stats)
    pstep = make_train_step()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for _ in range(steps):
        state, jm = jstep(state, batch)
        pstate, pm = pstep(pstate, tbatch)
        out.append(({k: float(v) for k, v in jm.items()},
                    {k: float(v) for k, v in pm.items()}))
    return out, flat(state.params), pstate


@pytest.mark.parametrize("name", ["vit-test", "vgg-test"])
def test_three_train_steps_match_the_reference(name):
    metrics, ref_params, pstate = _trajectories(name)
    for i, (jm, pm) in enumerate(metrics):
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(pm[key], jm[key],
                                       err_msg=f"{key} step {i}", **TOL)
    got = convert.params_to_flax(pstate.params)
    assert set(got) == set(ref_params)
    for key, value in ref_params.items():
        np.testing.assert_allclose(got[key], value, err_msg=key, **TOL)


def _classify_metadata(name, size, kw, dtype="float32"):
    return ModelMetadata(
        model_name=name, registry_name=name, model_kwargs=kw,
        signatures={"serving_default": Signature(
            method="classify",
            inputs={"images": TensorSpec(dtype, (-1, size, size, 3))},
            outputs={"classes": TensorSpec("int32", (-1, 3)),
                     "scores": TensorSpec("float32", (-1, 3))})})


def test_a_reference_export_serves_equal_on_the_port(tmp_path):
    """A JAX export of vit-test loaded by the port's ``load_version``
    serves the reference's classify."""
    size, kw = CASES["vit-test"]
    ref_model = get_jax_model("vit-test").make(dtype=jnp.float32, **kw)
    # The reference's loader wants the init's partitioning boxes.
    variables = jax.jit(lambda r: ref_model.init(
        r, jnp.zeros((1, size, size, 3)), train=False))(
            jax.random.PRNGKey(0))
    meta = _classify_metadata("vit-test", size, dict(kw, dtype="float32"))
    jax_export(str(tmp_path), 1, JaxMetadata.loads(meta.dumps()), variables)
    ref = jax_load_version(str(tmp_path / "1"), top_k=3)
    port = load_version(str(tmp_path / "1"), top_k=3, device="cpu")
    assert not port.batch_stats
    x = _images(5, 3, size)
    want = ref.run({"images": x})
    got = port.run({"images": x})
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["scores"], want["scores"],
                               atol=SERVE_TOL, rtol=SERVE_TOL)


def test_a_reference_export_with_batch_stats_serves_on_the_port(tmp_path):
    """A JAX export of Inception-v3 whose ``batch_stats`` are not the
    init's (drawn apart: means 0.1·N(0, 1), variances in [0.5, 1.5);
means of the order of the activations' would drive every logit to 0
through the ReLUs, and ties would decide the classes) loaded
    by the port: the statistics arrive exactly; ``classify`` is the
    reference's (its module applied in eval mode, ε = 1e-3, on the same
    variables, then the softmax's top 3) within ``SERVE_TOL``, its logits
    too (measured 9e-8 apart; an ε of 1e-5 in place of 1e-3 moves them
    1.2e-4); and it is the port's module applied bit for bit."""
    size, kw = CASES["inception-v3"]
    ref, variables, model, params, _ = _pair("inception-v3")
    rng = np.random.default_rng(8)
    stats = {k: (rng.uniform(0.5, 1.5, v.shape) if k.endswith("var")
                 else 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in flat(variables["batch_stats"]).items()}
    tree = {"params": variables["params"],
            "batch_stats": convert.unflatten_tree(stats)}
    meta = _classify_metadata("inception-v3", size,
                              dict(kw, dtype="float32"))
    jax_export(str(tmp_path), 1, JaxMetadata.loads(meta.dumps()), tree)
    port = load_version(str(tmp_path / "1"), top_k=3, device="cpu")
    for key, value in stats.items():
        assert np.array_equal(port.batch_stats[key.replace("/", ".")].numpy(),
                              value), key
    x = _images(5, 3, size)
    got = port.run({"images": x})
    want_logits = jax.jit(lambda v, x: ref.apply(v, x, train=False))(tree, x)
    # Logits that the statistics have not flattened: distinct classes.
    assert np.ptp(np.asarray(want_logits), axis=-1).min() > 1e-2
    want_scores, want_classes = jax.lax.top_k(
        jax.nn.softmax(want_logits.astype(jnp.float32), axis=-1), 3)
    np.testing.assert_array_equal(got["classes"], np.asarray(want_classes))
    np.testing.assert_allclose(got["scores"], np.asarray(want_scores),
                               atol=SERVE_TOL, rtol=SERVE_TOL)
    logits = apply(model, params, {k.replace("/", "."): torch.from_numpy(v)
                                   for k, v in stats.items()},
                   torch.from_numpy(x), train=False)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits),
                               atol=SERVE_TOL, rtol=SERVE_TOL)
    scores, classes = torch.topk(torch.softmax(logits.float(), -1), 3)
    np.testing.assert_array_equal(got["classes"], classes.numpy())
    np.testing.assert_array_equal(got["scores"], scores.numpy())


def test_port_export_with_batch_stats_serves_its_module(tmp_path):
    """The port's own export of Inception (params and ``batch_stats``)
    serves ``predict`` equal to the module applied, bitwise, and a bf16
    signature takes its images as bf16."""
    _, variables, model, params, stats = _pair("inception-v3")
    meta = ModelMetadata(
        model_name="inc", registry_name="inception-v3",
        model_kwargs={"num_classes": 10, "dtype": "float32"},
        signatures={"serving_default": Signature(
            method="predict",
            inputs={"images": TensorSpec("bfloat16", (-1, 75, 75, 3))},
            outputs={"logits": TensorSpec("float32", (-1, 10))})})
    tree = {"params": convert.unflatten_tree(convert.params_to_flax(params)),
            "batch_stats": convert.unflatten_tree(
                {k.replace(".", "/"): v.numpy() for k, v in stats.items()})}
    export_model(str(tmp_path), 2, meta, tree)
    served = load_version(str(tmp_path / "2"), device="cpu")
    x = _images(6, 2, 75)
    got = served.run({"images": x})["logits"]
    want = apply(model, params, stats,
                 torch.from_numpy(x).to(torch.bfloat16), train=False)
    assert np.array_equal(got, want.detach().numpy())


def test_an_export_with_an_unknown_collection_raises(tmp_path):
    meta = _classify_metadata("vit-test", 32, {"dtype": "float32"})
    export_model(str(tmp_path), 3, meta, {"params": {}, "cache": {}})
    with pytest.raises(NotImplementedError, match="cache"):
        load_version(str(tmp_path / "3"), device="cpu")


@pytest.mark.parametrize("name", ["vit-test", "vgg-test", "inception-v3"])
def test_the_tpu_cnn_benchmark_trains_every_vision_family(name):
    result = benchmark.run_benchmark(benchmark.BenchConfig(
        model=name, batch_size=4, steps=2, warmup_steps=1,
        image_size=CASES[name][0]), device="cpu")
    assert result["images_per_sec"] > 0
    assert all(np.isfinite(result["losses"]))
    assert result["flops_per_step"] > 0


def test_patch_size_must_divide_the_image():
    model = get_model("vit-test").make(dtype="float32")
    with pytest.raises(ValueError, match="not divisible by patch"):
        model(torch.zeros((1, 30, 30, 3)))


def test_vit_flash_flops_are_counted_beside_the_flop_counter():
    """The benchmark's FLOP counter sees attention as a forward and a
    backward of twice its work (benchmark.py's docstring): on the CPU
    that is the plain version's forward and backward."""
    from torch.utils.flop_counter import FlopCounterMode

    from kubeflow_tpu_torch.ops.flash_attention import (
        attention_flops,
        flash_attention,
    )

    # ViT-B16: 196 tokens, 12 heads of 64, non-causal.
    assert attention_flops(2, 12, 196, 196, 64) == 4 * 2 * 12 * 196 ** 2 * 64
    q, k, v = (torch.randn(2, 196, 3, 16, requires_grad=True)
               for _ in range(3))
    counter = FlopCounterMode(display=False)
    with counter:
        flash_attention(q, k, v).sum().backward()
    assert counter.get_total_flops() == 3 * attention_flops(2, 3, 196, 196,
                                                            16)
    # Causal at an offset: query i sees q_offset + i + 1 keys.
    assert attention_flops(1, 1, 3, 8, 2, causal=True, q_offset=5) == (
        4 * (6 + 7 + 8) * 2)
    assert attention_flops(1, 1, 4, 4, 2, causal=True) == 4 * 10 * 2
