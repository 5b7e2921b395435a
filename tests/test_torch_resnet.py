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

"""kubeflow_tpu_torch's ResNet vs kubeflow_tpu's, on ``resnet-test`` fp32.

The Flax variables (BN scales, biases and running statistics drawn at
random, so no branch starts as the identity) are carried across with
``params_from_flax`` / ``batch_stats_from_flax``; the same numpy-seeded
images go through both. Logits within atol 2e-4, as
tests/test_engine.py holds the s2d stem: fp32 convolutions summed in
another order through five stages. Convolutions and pooling with
Flax's asymmetric ``SAME`` padding are held exactly at their own scale
(1e-5).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from kubeflow_tpu.models.resnet import (
    ResNet as JaxResNet,
    resnet18ish as jax_resnet18ish,
    space_to_depth as jax_space_to_depth,
    stem_kernel_to_s2d as jax_stem_kernel_to_s2d,
)
from kubeflow_tpu_torch.models import convert, layers, resnet
from kubeflow_tpu_torch.models.registry import get_model

TOL = dict(atol=2e-4, rtol=2e-4)


def _images(seed, n=4, size=32):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(
        np.float32)


def _randomize(variables, seed):
    """Random BN scale/bias/mean/var (positive var), kernels as drawn."""
    rng = np.random.RandomState(seed)
    flat = {k: np.array(v) for k, v in flatten_dict(
        nn.meta.unbox(variables), sep="/").items()}
    for k, v in flat.items():
        if k.endswith(("/scale", "/var")):
            flat[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
        elif k.endswith(("/bias", "/mean")):
            flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    params = {k[len("params/"):]: v for k, v in flat.items()
              if k.startswith("params/")}
    stats = {k[len("batch_stats/"):]: v for k, v in flat.items()
             if k.startswith("batch_stats/")}
    return params, stats


def _unflatten(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return out


def _port(model, params, stats):
    return (convert.params_from_flax(params, model, device="cpu"),
            convert.batch_stats_from_flax(stats, model, device="cpu"))


@pytest.fixture(scope="module")
def flax_vars():
    model = jax_resnet18ish(dtype=jnp.float32)
    variables = jax.jit(lambda r: model.init(
        r, jnp.zeros((1, 32, 32, 3)), train=False))(jax.random.PRNGKey(0))
    return _randomize(variables, seed=1)


@pytest.mark.parametrize("train", [False, True])
def test_resnet_test_logits_match_flax(flax_vars, train):
    params, stats = flax_vars
    x = _images(2)
    jax_model = jax_resnet18ish(dtype=jnp.float32)
    variables = {"params": _unflatten(params),
                 "batch_stats": _unflatten(stats)}
    if train:
        ref, upd = jax_model.apply(variables, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
    else:
        ref = jax_model.apply(variables, jnp.asarray(x), train=False)
    model = get_model("resnet-test").make(dtype="float32")
    p, s = _port(model, params, stats)
    out = layers.apply(model, p, s, torch.from_numpy(x), train=train)
    assert out.dtype == torch.float32 and out.shape == (4, 10)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    if train:
        new = {k: np.asarray(v) for k, v in flatten_dict(
            upd["batch_stats"], sep="/").items()}
        for name, t in s.items():
            np.testing.assert_allclose(t.numpy(), new[name.replace(".", "/")],
                                       **TOL)


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("kernel,stride", [(3, 2), (7, 2), (1, 2), (3, 1)])
def test_same_padding_matches_flax_conv(size, kernel, stride):
    rng = np.random.RandomState(size + kernel)
    x = rng.randn(2, size, size, 5).astype(np.float32)
    w = rng.randn(kernel, kernel, 5, 6).astype(np.float32)
    ref = nn.Conv(6, (kernel, kernel), (stride, stride), padding="SAME",
                  use_bias=False).apply({"params": {"kernel": w}},
                                        jnp.asarray(x))
    conv = layers.Conv(5, 6, (kernel, kernel), (stride, stride),
                       device="cpu")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        out = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("size", [8, 9, 112])
def test_max_pool_same_matches_flax(size):
    x = np.random.RandomState(size).randn(2, size, size, 4).astype(np.float32)
    ref = nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME")
    out = layers.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref))


def test_s2d_stem_matches_flax_and_the_conv7_stem():
    jax_conv7 = JaxResNet(stage_sizes=(1,), num_classes=10, width=16,
                          dtype=jnp.float32, stem="conv7")
    x = _images(3, n=2, size=64)
    variables = jax.jit(lambda r: jax_conv7.init(
        r, jnp.asarray(x), train=False))(jax.random.PRNGKey(1))
    params, stats = _randomize(variables, seed=4)
    s2d_params = dict(params)
    s2d_params["conv_init/kernel"] = np.asarray(jax_stem_kernel_to_s2d(
        jnp.asarray(params["conv_init/kernel"])))
    ref = JaxResNet(stage_sizes=(1,), num_classes=10, width=16,
                    dtype=jnp.float32, stem="s2d").apply(
        {"params": _unflatten(s2d_params), "batch_stats": _unflatten(stats)},
        jnp.asarray(x), train=False)

    conv7 = resnet.ResNet((1,), num_classes=10, width=16, dtype="float32")
    s2d = resnet.ResNet((1,), num_classes=10, width=16, dtype="float32",
                        stem="s2d")
    # The port's kernel transform is the reference's, value for value.
    w7 = torch.from_numpy(params["conv_init/kernel"])
    np.testing.assert_array_equal(resnet.stem_kernel_to_s2d(w7).numpy(),
                                  s2d_params["conv_init/kernel"])
    out_s2d = layers.apply(s2d, *_port(s2d, s2d_params, stats),
                           torch.from_numpy(x), train=False)
    out_conv7 = layers.apply(conv7, *_port(conv7, params, stats),
                             torch.from_numpy(x), train=False)
    np.testing.assert_allclose(out_s2d.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out_s2d.numpy(), out_conv7.numpy(), **TOL)


def test_space_to_depth_packing_matches_flax():
    probe = np.arange(2 * 4 * 4 * 3, dtype=np.float32).reshape(2, 4, 4, 3)
    np.testing.assert_array_equal(
        resnet.space_to_depth(torch.from_numpy(probe)).numpy(),
        np.asarray(jax_space_to_depth(jnp.asarray(probe))))


def test_params_from_flax_rejects_a_misranked_kernel(flax_vars):
    params, _ = flax_vars
    model = get_model("resnet-test").make(dtype="float32")
    bad = dict(params)
    bad["stage1_block1/conv1/kernel"] = bad["stage1_block1/conv1/kernel"][0]
    with pytest.raises(ValueError, match="rank-3"):
        convert.params_from_flax(bad, model, device="cpu")


def test_conv_kernels_keep_their_spatial_taps(flax_vars):
    # HWIO → OIHW must not swap H and W: a 3x3 kernel reversed whole
    # (arr.T) has the right shape and the wrong taps.
    params, _ = flax_vars
    model = get_model("resnet-test").make(dtype="float32")
    p = convert.params_from_flax(params, model, device="cpu")
    hwio = params["stage2_block1/conv2/kernel"]
    oihw = p["stage2_block1.conv2.weight"].numpy()
    assert oihw[5, 3, 0, 2] == hwio[0, 2, 3, 5]


def test_init_resnet_follows_the_reference_initializers():
    model = get_model("resnet50").make()
    params, stats = convert.init_vision(model, seed=0, device="cpu")
    assert len([n for n in stats if n.endswith(".mean")]) == 53
    assert sum(t.numel() for t in params.values()) == 25_557_032
    assert all(t.dtype == torch.float32 for t in params.values())
    assert torch.all(params["stage1_block1.bn3.scale"] == 0)
    assert torch.all(params["stage1_block1.bn1.scale"] == 1)
    assert torch.all(params["head.bias"] == 0)
    w = params["stage4_block3.conv2.weight"]  # fan_in 3*3*512
    std = (3 * 3 * 512) ** -0.5
    assert abs(float(w.std()) / std - 1) < 0.02
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert torch.all(stats["bn_init.var"] == 1)
    assert torch.all(stats["bn_init.mean"] == 0)
