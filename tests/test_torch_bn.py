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

import importlib.util
import os

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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


#: ResNet-50 at b256, 224²: each distinct [M, C] its BN layers give the
#: kernel, and how many layers (v1.5: each stage's first bn1 runs at the
#: previous stage's resolution).
RESNET50_BN_SHAPES = [
    (3211264, 64, 1), (802816, 64, 6), (802816, 256, 4), (802816, 128, 1),
    (200704, 128, 7), (200704, 512, 5), (200704, 256, 1), (50176, 256, 11),
    (50176, 1024, 7), (50176, 512, 1), (12544, 512, 5), (12544, 2048, 4)]
#: The H100's limits as the card reports them: 132 SMs, one block of
#: the kernel each at the opt-in 227 KB of shared memory.
H100_CORESIDENT = 132
H100_OPTIN_SMEM = 232448
#: (M, C, vec, element bytes, stat_rows): every ResNet-50 shape exact
#: and with the leading 32 of 256 images as stat rows, then ragged and
#: tiny cases.
PLAN_CASES = ([(m, c, 8, 2, None) for m, c, _ in RESNET50_BN_SHAPES]
              + [(m, c, 8, 2, m // 8) for m, c, _ in RESNET50_BN_SHAPES]
              + [(100003, 99, 1, 4, None), (100003, 99, 1, 4, 4099),
                 (7, 3, 1, 4, None), (1, 4, 4, 4, None),
                 (4099, 256, 8, 2, 1)])


def _plan(m, c, vec, elem, stat_rows, coresident=H100_CORESIDENT,
          slab=None):
    if slab is None:
        slab = H100_OPTIN_SMEM - bn_fused.scratch_bytes(vec)
    return launch_plan(m, c, vec, elem, stat_rows, coresident=coresident,
                       slab_bytes=slab), slab


def test_resnet50_bn_shapes_are_the_models():
    # chip_smoke.py reads the shapes off the model (a meta-device
    # forward); they are the table above, 53 layers.
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.resnet50_bn_shapes() == RESNET50_BN_SHAPES
    assert sum(n for *_, n in RESNET50_BN_SHAPES) == 53


@pytest.mark.parametrize("m,c,vec,elem,stat_rows", PLAN_CASES)
def test_launch_plan_covers_every_row_and_channel(m, c, vec, elem,
                                                  stat_rows):
    plan, slab = _plan(m, c, vec, elem, stat_rows)
    m_stat = m if stat_rows is None else stat_rows
    assert plan.tx * plan.ty == bn_fused.THREADS
    assert plan.ty & (plan.ty - 1) == 0 and plan.tx <= bn_fused.TX_MAX
    assert plan.tx * plan.c_tiles * vec >= c > plan.tx * (plan.c_tiles
                                                          - 1) * vec
    # Chunk k sums stat rows [k·stat_per, …) and normalizes them and
    # its share of the rest: every row once.
    assert plan.chunks * plan.stat_per >= m_stat
    assert plan.chunks * plan.rest_per >= m - m_stat
    # ... and no chunk is left without a row.
    last = plan.chunks - 1
    assert last * plan.stat_per < m_stat or last * plan.rest_per < m - m_stat
    width = min(plan.tx * vec, c) * elem
    assert 0 <= plan.keep <= plan.stat_per and plan.keep * width <= slab
    assert plan.smem_bytes == bn_fused.scratch_bytes(vec) + plan.keep * width
    assert plan.smem_bytes <= H100_OPTIN_SMEM
    assert plan.grid <= H100_CORESIDENT
    if vec == 1:  # the scalar path streams: no 16-byte cp.async
        assert plan.keep == 0 and plan.route == "stream"


@pytest.mark.parametrize("m,c,vec,elem,stat_rows", PLAN_CASES)
def test_launch_plan_takes_the_onchip_route_exactly_when_the_slab_fits(
        m, c, vec, elem, stat_rows):
    plan, slab = _plan(m, c, vec, elem, stat_rows)
    slab_bytes = plan.stat_per * min(plan.tx * vec, c) * elem
    fits = vec > 1 and slab_bytes <= slab
    assert (plan.route == "onchip") == fits
    assert plan.keep == (plan.stat_per if fits else plan.keep)
    if vec > 1:  # at the edge: one byte less and the slab streams
        assert _plan(m, c, vec, elem, stat_rows,
                     slab=slab_bytes)[0].route == "onchip"
        assert _plan(m, c, vec, elem, stat_rows,
                     slab=slab_bytes - 1)[0].route == "stream"


def test_the_smallest_resnet50_layers_read_x_once():
    # Exact BN on the H100: the 16 layers of 12.8 and 25.7 MB fit on
    # chip; every other layer streams, keeping what fits.
    onchip = [(m, c, n) for m, c, n in RESNET50_BN_SHAPES
              if _plan(m, c, 8, 2, None)[0].route == "onchip"]
    assert onchip == [(50176, 256, 11), (12544, 512, 5)]


@pytest.mark.parametrize("coresident", [1, 3, 7, 66, 132, 264, 1056])
@pytest.mark.parametrize("m,c,vec,elem,stat_rows", PLAN_CASES[::3])
def test_launch_plan_grid_never_exceeds_the_coresident_count(
        coresident, m, c, vec, elem, stat_rows):
    plan, _ = _plan(m, c, vec, elem, stat_rows, coresident=coresident)
    if plan.c_tiles <= coresident:
        assert plan.grid <= coresident
    else:  # no plan fits: one chunk, and the launch refuses the grid
        assert plan.chunks == 1


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
