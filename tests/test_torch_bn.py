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

"""kubeflow_tpu_torch's batch norm vs kubeflow_tpu's, on the CPU.

``fused_bn_train_forward`` (its plain path here) against the Pallas
kernel in interpret mode and the reference's plain version, with the
tolerances of tests/test_bn_pallas.py; ``GhostBatchNorm`` against the
Flax module — output, running statistics and gradients (``jax.vjp``)
within 1e-5 in fp32, where only summation order differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.batch_norm import GhostBatchNorm as JaxGhostBatchNorm
from kubeflow_tpu.ops.bn_pallas import (
    fused_bn_train_forward as jax_fused_bn,
    reference_bn_train_forward as jax_reference_bn,
)
from kubeflow_tpu_torch.ops import bn_fused
from kubeflow_tpu_torch.ops.batch_norm import GhostBatchNorm, rows_view
from kubeflow_tpu_torch.ops.bn_fused import (
    fused_bn_train_forward,
    launch_plan,
    reference_bn_train_forward,
)


def _inputs(m, c, seed=0):
    x = np.random.RandomState(seed).randn(m, c).astype(np.float32) * 2 + 0.5
    scale = np.random.RandomState(seed + 1).rand(c).astype(np.float32)
    bias = np.random.RandomState(seed + 2).randn(c).astype(np.float32)
    return x, scale, bias


def _port(x, scale, bias, dtype, **kw):
    y, mean, var = fused_bn_train_forward(
        torch.from_numpy(x).to(dtype), torch.from_numpy(scale),
        torch.from_numpy(bias), **kw)
    return y.float().numpy(), mean.numpy(), var.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_pallas_kernel_and_reference(dtype):
    x, scale, bias = _inputs(1024, 128)
    jx = jnp.asarray(x, dtype)
    pallas = jax_fused_bn(jx, scale, bias, block_m=256, interpret=True)
    plain = jax_reference_bn(jx, scale, bias)
    got = _port(x, scale, bias, getattr(torch, dtype))
    tol = 1e-4 if dtype == "float32" else 5e-2
    for ref in (pallas, plain):
        y_ref, mean_ref, var_ref = (np.asarray(r, np.float32) for r in ref)
        np.testing.assert_allclose(got[1], mean_ref, atol=tol)
        np.testing.assert_allclose(got[2], var_ref, atol=tol)
        np.testing.assert_allclose(got[0], y_ref, atol=10 * tol)


@pytest.mark.parametrize("m,c", [(4096, 64), (1000, 64), (777, 99)])
def test_shapes_the_tpu_kernel_refuses(m, c):
    # C = 64 (ResNet-50's stem and stage 1) and ragged M: the Pallas
    # kernel takes neither; the port does.
    x, scale, bias = _inputs(m, c, seed=3)
    ref = [np.asarray(r) for r in jax_reference_bn(jnp.asarray(x), scale,
                                                    bias)]
    got = _port(x, scale, bias, torch.float32)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_stat_rows_take_the_leading_rows():
    x, scale, bias = _inputs(512, 32, seed=4)
    y, mean, var = _port(x, scale, bias, torch.float32, stat_rows=100)
    ref = [np.asarray(r) for r in jax_reference_bn(jnp.asarray(x[:100]),
                                                    scale, bias)]
    np.testing.assert_allclose(mean, ref[1], atol=1e-5)
    np.testing.assert_allclose(var, ref[2], atol=1e-5)
    # Every row is normalized with the leading rows' statistics.
    expect = (x - ref[1]) / np.sqrt(ref[2] + 1e-5) * scale + bias
    np.testing.assert_allclose(y, expect, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("bad", ["rank", "strided", "float16", "stat_zero",
                                 "stat_over", "scale_shape", "empty"])
def test_wrapper_validates_inputs(bad):
    x = torch.zeros(16, 8)
    scale, bias = torch.ones(8), torch.zeros(8)
    kw = {}
    if bad == "rank":
        x = x.view(2, 8, 8)
    elif bad == "strided":
        x = torch.zeros(8, 16).t()
    elif bad == "float16":
        x = x.half()
    elif bad == "stat_zero":
        kw["stat_rows"] = 0
    elif bad == "stat_over":
        kw["stat_rows"] = 17
    elif bad == "scale_shape":
        scale = torch.ones(9)
    elif bad == "empty":
        x = torch.zeros(0, 8)
    with pytest.raises(ValueError):
        fused_bn_train_forward(x, scale, bias, **kw)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch(monkeypatch):
    def no_build(name):
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr(bn_fused._build, "load", no_build)
    monkeypatch.setattr(fused_bn_train_forward, "launches", 0)
    x = torch.randn(300, 64)
    s, b = torch.rand(64), torch.randn(64)
    out = fused_bn_train_forward(x, s, b, stat_rows=100)
    ref = reference_bn_train_forward(x, s, b, stat_rows=100)
    assert all(torch.equal(a, r) for a, r in zip(out, ref))
    assert fused_bn_train_forward.launches == 0


@pytest.mark.parametrize("rows,c,vec", [
    (3211264, 64, 8), (802816, 256, 8), (100352, 256, 8),
    (12544, 2048, 8), (100003, 99, 1), (7, 3, 1), (1, 4, 4)])
def test_launch_plan_covers_every_row_and_channel(rows, c, vec):
    tx, ty, c_tiles, chunks, per_chunk = launch_plan(rows, c, vec)
    assert tx * ty == bn_fused.THREADS and ty & (ty - 1) == 0
    assert tx * c_tiles * vec >= c > tx * (c_tiles - 1) * vec
    assert chunks * per_chunk >= rows > (chunks - 1) * per_chunk
    assert 1 <= chunks <= 65535  # the grid's y limit


def _ghost_pair(stat_rows, n=8, h=4, w=4, c=16):
    rng = np.random.RandomState(7)
    x = (rng.randn(n, h, w, c) * 1.5 + 0.3).astype(np.float32)
    scale = rng.rand(c).astype(np.float32) + 0.5
    bias = rng.randn(c).astype(np.float32)
    ra_mean = rng.randn(c).astype(np.float32) * 0.1
    ra_var = rng.rand(c).astype(np.float32) + 0.5
    ct = rng.randn(n, h, w, c).astype(np.float32)
    return x, scale, bias, ra_mean, ra_var, ct


@pytest.mark.parametrize("stat_rows", [0, 4, 100])
def test_ghost_batch_norm_train_matches_flax(stat_rows):
    x, scale, bias, ra_mean, ra_var, ct = _ghost_pair(stat_rows)
    module = JaxGhostBatchNorm(dtype=jnp.float32, stat_rows=stat_rows)
    stats = {"mean": jnp.asarray(ra_mean), "var": jnp.asarray(ra_var)}

    def fwd(xx, s, b):
        return module.apply({"params": {"scale": s, "bias": b},
                             "batch_stats": stats}, xx,
                            mutable=["batch_stats"])

    args = (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    y_ref, vjp, upd = jax.vjp(fwd, *args, has_aux=True)
    gx_ref, gs_ref, gb_ref = vjp(jnp.asarray(ct))

    bn = GhostBatchNorm(16, dtype="float32", stat_rows=stat_rows,
                        device="cpu")
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.mean.copy_(torch.from_numpy(ra_mean))
        bn.var.copy_(torch.from_numpy(ra_var))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = bn(xt, train=True)
    y.backward(torch.from_numpy(ct).permute(0, 3, 1, 2))
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y_ref), **tol)
    np.testing.assert_allclose(bn.mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), **tol)
    np.testing.assert_allclose(bn.var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), **tol)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx_ref), **tol)
    np.testing.assert_allclose(bn.scale.grad.numpy(), np.asarray(gs_ref),
                               **tol)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gb_ref),
                               **tol)


def test_ghost_batch_norm_eval_uses_running_stats():
    x, scale, bias, ra_mean, ra_var, _ = _ghost_pair(0)
    module = JaxGhostBatchNorm(use_running_average=True, dtype=jnp.float32)
    ref = module.apply({"params": {"scale": scale, "bias": bias},
                        "batch_stats": {"mean": ra_mean, "var": ra_var}},
                       jnp.asarray(x))
    bn = GhostBatchNorm(16, dtype="float32", device="cpu")
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.mean.copy_(torch.from_numpy(ra_mean))
        bn.var.copy_(torch.from_numpy(ra_var))
        y = bn(torch.from_numpy(x).permute(0, 3, 1, 2), train=False)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    # The running statistics are read, never written, in eval mode.
    np.testing.assert_array_equal(bn.mean.numpy(), ra_mean)


def test_ghost_batch_norm_refuses_other_layouts_and_dtypes():
    bn = GhostBatchNorm(8, dtype="float32", device="cpu")
    nchw = torch.zeros(2, 8, 4, 4)  # contiguous NCHW, not channels-last
    with pytest.raises(ValueError, match="channels-last"):
        bn(nchw)
    with pytest.raises(ValueError):
        bn(torch.zeros(2, 4, 4, 8, dtype=torch.bfloat16).permute(0, 3, 1, 2))
    cl = torch.zeros(2, 4, 4, 8).permute(0, 3, 1, 2)
    assert rows_view(cl).shape == (32, 8)
