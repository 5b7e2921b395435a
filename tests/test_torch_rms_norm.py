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

"""The RMSNorm kernel's fused entry, ``add_rms_norm``, on the CPU.

Its CPU route is the plain composition (the residual add, then the
formula) bit for bit, and its norm holds against the reference's
``RMSNorm`` on the same sum; its ``autograd.Function``, with the kernel
swapped for the plain composition, gives the composition's gradients.
A Llama that hands each residual to the next norm (1 plain and 2·layers
fused norms a forward) gives the logits, loss and gradients of the
module that adds each residual where the reference does, with and
without remat, dense and MoE. The kernel itself runs in
tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kubeflow_tpu.models.llama import RMSNorm as JaxRMSNorm
from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.models.convert import init_params
from kubeflow_tpu_torch.ops import rms_norm as rn

EPS = 1e-5


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _inputs(seed, rows, d, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(_normal(rng, rows, d) * 3 + 0.5).to(dtype)
    delta = torch.from_numpy(_normal(rng, rows, d)).to(dtype)
    scale = torch.from_numpy(1 + 0.1 * _normal(rng, d)).to(dtype)
    return x, delta, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 1024, 4096])
def test_add_rms_norm_cpu_route_is_the_plain_composition(dtype, d):
    x, delta, scale = _inputs(d, 5, d, dtype)
    before = rn.rms_norm.launches, rn.add_rms_norm.launches
    s, y = rn.add_rms_norm(x, delta, scale, EPS)
    assert (rn.rms_norm.launches, rn.add_rms_norm.launches) == before
    want = x + delta
    assert s.dtype == y.dtype == dtype
    assert torch.equal(s, want)
    assert torch.equal(y, rn.rms_norm_reference(want, scale, EPS))
    assert torch.equal(y, rn.rms_norm(want, scale, EPS))


@pytest.mark.parametrize("d", [64, 1024, 4096])
def test_add_rms_norm_matches_the_reference_on_the_sum(d):
    rng = np.random.default_rng(d)
    x, delta = _normal(rng, 3, d) * 3 + 0.5, _normal(rng, 3, d)
    scale = 1 + 0.1 * _normal(rng, d)
    total = x + delta
    want = JaxRMSNorm(dtype=jnp.float32).apply(
        {"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(total))
    s, y = rn.add_rms_norm(torch.from_numpy(x), torch.from_numpy(delta),
                           torch.from_numpy(scale), EPS)
    np.testing.assert_array_equal(s.numpy(), total)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("wanted", ["all", "x", "delta", "scale",
                                    "delta_scale"])
def test_add_rms_norm_gradient_recomputes_the_composition(monkeypatch,
                                                          wanted):
    """The fused autograd.Function, with the kernel swapped for the
    plain composition: the gradients of a loss on both outputs are the
    composition's, and only the inputs that want one get one."""
    monkeypatch.setattr(rn, "_launch", lambda x, scale, eps, delta:
                        rn.add_rms_norm_reference(x, delta, scale, eps))
    rng = np.random.default_rng(7)
    x, delta, scale = _inputs(7, 4, 32)
    gs, gy = (torch.from_numpy(_normal(rng, 4, 32)) for _ in range(2))
    want_grad = {"all": (1, 1, 1), "x": (1, 0, 0), "delta": (0, 1, 0),
                 "scale": (0, 0, 1), "delta_scale": (0, 1, 1)}[wanted]

    def grads(fn):
        leaves = [t.clone().requires_grad_(bool(w))
                  for t, w in zip((x, delta, scale), want_grad)]
        s, y = fn(*leaves, EPS)
        ((s * gs).sum() + (y * gy).sum()).backward()
        return [t.grad for t in leaves]

    got = grads(rn._AddRMSNorm.apply)
    ref = grads(rn.add_rms_norm_reference)
    for a, b, w in zip(got, ref, want_grad):
        if not w:
            assert a is None and b is None
            continue
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    if want_grad[0] and want_grad[1]:
        assert torch.equal(got[0], got[1])


def _unfused_block(self, x, positions, pad_lengths=None, cache=None,
                   decode_positions=None, pending=None):
    """The block as the reference writes it: each residual added before
    the next norm, in the block, by a plain add."""
    if pending is not None:
        x = x + pending
    route = llama._route(x, cache, decode_positions)
    x = x + self.attention(self.attn_norm(x), positions, pad_lengths,
                           cache, decode_positions)
    h = self.mlp_norm(x)
    if self.moe is not None:
        return x + self.moe(h), None
    h = (F.silu(llama._project(self.gate_proj, h, route))
         * llama._project(self.up_proj, h, route))
    return x + llama._project(self.down_proj, h, route), None


def _logits_loss_grads(model, params, ids):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    logits = llama.apply(model, leaves, ids)
    loss = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           ids[:, 1:].reshape(-1).long())
    loss.backward()
    return logits.detach(), loss.detach(), {k: v.grad
                                            for k, v in leaves.items()}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", ["llama-test", "llama-moe-test"])
def test_fused_llama_equals_the_unfused_module(monkeypatch, name, remat):
    make = {"llama-test": llama.llama_test,
            "llama-moe-test": llama.llama_moe_test}[name]
    model = make(dtype="float32", remat=remat)
    params = init_params(model, seed=3, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (2, 16)).astype(np.int32))
    calls = {"rms_norm": 0, "add_rms_norm": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    with monkeypatch.context() as patch:
        for fn in calls:
            patch.setattr(llama, fn, counting(fn, getattr(llama, fn)))
        fused = _logits_loss_grads(model, params, ids)
    layers = model.num_layers
    # The forward's norms, and under remat each block's again (layer 0's
    # attention norm is a plain one there too).
    assert calls == {"rms_norm": 1 + remat,
                     "add_rms_norm": 2 * layers + remat * (2 * layers - 1)}
    monkeypatch.setattr(llama.LlamaBlock, "forward", _unfused_block)
    unfused = _logits_loss_grads(model, params, ids)
    for got, want in zip(fused[:2], unfused[:2]):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert fused[2].keys() == unfused[2].keys()
    for key, grad in fused[2].items():
        torch.testing.assert_close(grad, unfused[2][key], rtol=1e-6,
                                   atol=1e-6, msg=key)


def test_fused_llama_selects_the_pending_rows_with_logits_at():
    """A cache forward reading one column a row: the pending residual's
    rows are selected with the stream's before the final fused norm."""
    model = llama.llama_test(dtype="float32", cache_size=16)
    params = init_params(model, seed=4, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        0, 512, (2, 6)).astype(np.int32))
    at = torch.tensor([5, 2])
    with torch.inference_mode():
        full = llama.apply(model, params, ids, cache=_cache(model, 2))
        read = llama.apply(model, params, ids, cache=_cache(model, 2),
                           logits_at=at)
    assert read.shape == (2, 1, 512)
    for b in range(2):
        torch.testing.assert_close(read[b, 0], full[b, at[b]], rtol=1e-6,
                                   atol=1e-6)


def _cache(model, b):
    shape = (b, model.cache_size, model.num_kv_heads, model.head_dim)
    return [llama.LayerCache(torch.zeros(shape), torch.zeros(shape))
            for _ in range(model.num_layers)]


@pytest.mark.parametrize("bad", ["float16", "width", "dtype_delta",
                                 "dtype_scale", "shape_delta",
                                 "shape_scale", "device", "scale_strided",
                                 "misaligned"])
def test_add_rms_norm_checks_what_the_kernel_takes(bad):
    x, delta, scale = _inputs(0, 2, 64)
    if bad == "float16":
        x, delta, scale = x.half(), delta.half(), scale.half()
    elif bad == "width":
        x, delta, scale = _inputs(0, 2, 128)
    elif bad == "dtype_delta":
        delta = delta.to(torch.bfloat16)
    elif bad == "dtype_scale":
        scale = scale.to(torch.bfloat16)
    elif bad == "shape_delta":
        delta = delta[:1]
    elif bad == "shape_scale":
        scale = torch.ones(32)
    elif bad == "device":
        delta = torch.empty(2, 64, device="meta")
    elif bad == "scale_strided":
        scale = torch.ones(128)[::2]
    else:
        scale = torch.ones(65)[1:]
    with pytest.raises(ValueError):
        rn._check_inputs(x, scale, delta)


def test_wrappers_refuse_a_device_other_than_cpu_or_cuda():
    x = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rn.add_rms_norm(x, x, torch.empty(64, device="meta"), EPS)
    with pytest.raises(ValueError, match="cuda or cpu"):
        rn.rms_norm(x, torch.empty(64, device="meta"), EPS)


def test_packed_arguments_follow_the_kernels_struct():
    """The wrapper's argument block is ``KftRmsNormArgs`` of
    ``csrc/rms_norm.cu`` field for field: pointers and ``long long`` as
    8 bytes, ``int`` and ``float`` as 4, in the struct's order, 72 bytes
    in all."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(rn.__file__), os.pardir,
                            "csrc", "rms_norm.cu")).read()
    body = re.search(r"struct KftRmsNormArgs \{(.*?)\};", src, re.S).group(1)
    codes = {"long long": "q", "int": "i", "float": "f"}
    fields = [f.strip() for f in body.split(";") if f.strip()]
    packed = "".join("q" if "*" in f else codes[f.rsplit(" ", 1)[0]]
                     for f in fields)
    assert [f.rsplit(" ", 1)[-1].lstrip("*") for f in fields] == [
        "x", "delta", "scale", "s", "y", "rows", "stream", "dtype", "d",
        "eps", "unused"]
    assert packed == "qqqqqqqiifi"
    assert rn._ARGS.format == "<7q2if4x" and rn._ARGS.size == 72
