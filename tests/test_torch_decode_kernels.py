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

"""The decode step's kernels through their plain twins on the CPU, and
the flash kernel's gradient.

The decode GEMM's twin computes every row alone, so a row's bits do not
depend on the row count; the RMSNorm and decode-attention twins hold
against the reference's ``RMSNorm`` and ``dense_attention``; the flash
wrapper's gradient (the plain version's autograd on the CPU, the
recompute of its ``autograd.Function`` on the card) holds against the
reference's dense gradients, as tests/test_flash_attention.py holds the
Pallas kernel's. A llama-test decode step routes every linear, norm and
attention through the three wrappers, and a prefill routes none of its
linears there. The kernels themselves run in tests/test_torch_gpu.py.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kubeflow_tpu.models.llama import RMSNorm as JaxRMSNorm
from kubeflow_tpu.ops.attention import dense_attention as jax_dense_attention
from kubeflow_tpu_torch.inference.generate import (
    _row_cumsum,
    generate,
    init_cache,
)
from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.models.convert import init_params
from kubeflow_tpu_torch.ops import decode_attention as da
from kubeflow_tpu_torch.ops import decode_gemm as dg
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.ops import rms_norm as rn


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- decode GEMM -----------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", range(1, 9))
def test_decode_linear_twin_rows_equal_each_row_alone(dtype, m):
    rng = np.random.default_rng(m)
    x = torch.from_numpy(_normal(rng, m, 1, 64)).to(dtype)
    w = torch.from_numpy(_normal(rng, 96, 64) * 0.1).to(dtype)
    out = dg.decode_linear(x, w)
    assert out.shape == (m, 1, 96) and out.dtype == dtype
    for i in range(m):
        assert torch.equal(out[i], dg.decode_linear(x[i:i + 1], w)[0])
    torch.testing.assert_close(out.float(), F.linear(x, w).float(),
                               rtol=1e-2 if dtype == torch.bfloat16 else 1e-5,
                               atol=1e-2 if dtype == torch.bfloat16 else 1e-5)


def test_decode_linear_cpu_twin_launches_nothing():
    before = dg.decode_linear.launches
    dg.decode_linear(torch.ones(2, 16), torch.ones(8, 16))
    assert dg.decode_linear.launches == before


@pytest.mark.parametrize("bad", ["k_mismatch", "dtype_mix", "float16",
                                 "k_not_vector", "w_strided"])
def test_decode_linear_checks_what_the_kernel_takes(bad):
    x, w = torch.ones(2, 64), torch.ones(8, 64)
    if bad == "k_mismatch":
        w = torch.ones(8, 32)
    elif bad == "dtype_mix":
        w = w.to(torch.bfloat16)
    elif bad == "float16":
        x, w = x.half(), w.half()
    elif bad == "k_not_vector":
        x, w = torch.ones(2, 6), torch.ones(8, 6)
    else:
        w = torch.ones(64, 8).t()
    with pytest.raises(ValueError):
        dg._check_inputs(x, w)


# -- RMSNorm ---------------------------------------------------------------


@pytest.mark.parametrize("rows,d", [(1, 64), (5, 64), (3, 4096)])
def test_rms_norm_twin_matches_the_reference(rows, d):
    rng = np.random.default_rng(d + rows)
    x = _normal(rng, rows, d) * 3 + 0.5
    scale = 1 + 0.1 * _normal(rng, d)
    module = JaxRMSNorm(dtype=jnp.float32)
    want = module.apply({"params": {"scale": jnp.asarray(scale)}},
                        jnp.asarray(x))
    got = rn.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_rms_norm_gradient_recomputes_the_formula(monkeypatch):
    """The kernel's autograd.Function, with the kernel swapped for its
    twin: the gradients are the formula's own."""
    monkeypatch.setattr(rn, "_launch", rn.rms_norm_reference)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_normal(rng, 4, 32)).requires_grad_()
    scale = torch.from_numpy(1 + 0.1 * _normal(rng, 32)).requires_grad_()
    gy = torch.from_numpy(_normal(rng, 4, 32))
    got = torch.autograd.grad(rn._RMSNorm.apply(x, scale, 1e-5), (x, scale),
                              gy)
    want = torch.autograd.grad(rn.rms_norm_reference(x, scale, 1e-5),
                               (x, scale), gy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- decode attention -------------------------------------------------------


@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2), (4, 1)])
def test_decode_attention_twin_matches_the_reference(h, hkv):
    """One query per row over a cache with per-row valid spans: a row
    left-padded, a row valid to its end, and a fully masked row (0)."""
    rng = np.random.default_rng(h * 10 + hkv)
    b, s, d = 3, 40, 16
    q = _normal(rng, b, 1, h, d)
    k, v = _normal(rng, b, s, hkv, d), _normal(rng, b, s, hkv, d)
    pos = np.arange(s)
    valid = np.stack([(pos >= 5) & (pos <= 30), pos <= 39,
                      np.zeros(s, bool)])
    want = jax_dense_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), kv_segment_valid=valid)
    got = da.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    assert not got[2].any()


def test_decode_attention_smem_bound_raises_past_shared_memory():
    q = torch.ones(1, 1, 32, 128)
    ok = torch.ones(1, 544, 8, 128)
    da._check_inputs(q, ok, ok, torch.ones(1, 544, dtype=torch.bool))
    # Ranges of 128 keys (544 is in the second 512-key band), five CTAs:
    # the 128 bf16 V rows, then in fp32 q, the scores, the CTA's partial
    # output and 3 statistics a head, then a validity byte a key.
    assert (da.span(544), da.splits(544)) == (128, 5)
    assert da.smem_bytes(32, 8, 544, 128, 2) == (
        128 * 256 + 4 * 4 * (128 + 128 + 128 + 3) + 128)
    # Past 32 KB of V rows a CTA, two stages of them in turn.
    assert da.smem_bytes(32, 8, 8192, 128, 2) == (
        2 * 128 * 256 + 4 * 4 * (128 + 1024 + 128 + 3) + 1024)
    # llama3-8b's full context fits; a CTA's share past ~110k keys not.
    ctx = torch.ones(1, 1, 8, 128).expand(1, 8192, 8, 128)
    da._check_inputs(q, ctx, ctx, torch.ones(1, 8192, dtype=torch.bool))
    long = torch.ones(1, 1, 8, 128).expand(1, 120000, 8, 128)
    with pytest.raises(ValueError, match="shared memory"):
        da._check_inputs(q, long, long,
                         torch.ones(1, 120000, dtype=torch.bool))
    for bad_q, bad_kv in ((torch.ones(1, 1, 36, 128), ok[:, :, :4]),
                          (torch.ones(1, 1, 32, 96), torch.ones(1, 544, 8,
                                                               96))):
        with pytest.raises(ValueError, match="KV head|head_dim"):
            da._check_inputs(bad_q, bad_kv, bad_kv,
                             torch.ones(1, 544, dtype=torch.bool))


# -- the decode step's routing ---------------------------------------------


@pytest.mark.parametrize("page", [1, 2, 4, 8, 16, 32, 64, 128, 256, 512])
def test_decode_attention_ranges_do_not_move_when_a_page_pads_the_cache(
        page):
    # The kernel's key ranges are fixed by S's 512-key band: a cache
    # rounded up to whole pages of a size that divides 512 keeps them.
    for s in range(1, 8193):
        padded = -(-s // page) * page
        assert da.span(padded) == da.span(s), (s, padded)
        assert da.splits(s) <= da.splits(padded) <= da.MAX_SPLIT
        assert 1 <= s - (da.splits(s) - 1) * da.span(s) <= da.span(s)


def test_decode_step_routes_through_the_three_wrappers(monkeypatch):
    """llama-test generate: each decode step sends its 7 linears a layer
    and the lm_head through decode_linear, its norms through the RMSNorm
    kernel's two entries (layer 0's attention norm through rms_norm, the
    other norm a layer and the final one through add_rms_norm, which
    takes the residual add before it: no residual add runs outside it),
    and its attention through decode_attention; the prefill sends its
    attention once a layer, the whole block at the cache's index, to
    prefill_attention (the flash kernel on the card), none to
    decode_attention, and only its head, at the one position a row
    generate reads, to decode_linear."""
    calls = {"decode_linear": 0, "rms_norm": 0, "add_rms_norm": 0,
             "decode_attention": 0, "prefill_attention": 0}
    offsets = []
    inside_fused = [0]
    model = llama.llama_test(dtype="float32", cache_size=32)

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            if name == "prefill_attention":
                offsets.append((a[3], a[0].shape[1]))
            inside_fused[0] += name == "add_rms_norm"
            try:
                return fn(*a, **kw)
            finally:
                inside_fused[0] -= name == "add_rms_norm"
        return wrapped

    for name in calls:
        monkeypatch.setattr(llama, name, counting(name, getattr(llama, name)))
    # A residual add: two float tensors of the stream's [B, L, d_model].
    residual_adds = [0]
    tensor_add = torch.Tensor.__add__

    def add(a, b):
        if (not inside_fused[0] and isinstance(b, torch.Tensor)
                and a.is_floating_point() and a.dim() == 3
                and a.shape[-1] == model.d_model and b.shape == a.shape):
            residual_adds[0] += 1
        return tensor_add(a, b)

    monkeypatch.setattr(torch.Tensor, "__add__", add)
    params = init_params(model, seed=0, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (2, 8)).astype(np.int32))
    layers = model.num_layers
    generate(model, params, ids, max_new_tokens=1)
    assert calls == {"decode_linear": 1, "rms_norm": 1,
                     "add_rms_norm": 2 * layers,
                     "decode_attention": 0, "prefill_attention": layers}
    assert calls["rms_norm"] + calls["add_rms_norm"] == 5
    assert offsets == [(0, 8)] * layers
    generate(model, params, ids, max_new_tokens=4)
    steps = 3
    forwards = steps + 2
    assert calls == {"decode_linear": 2 + steps * (7 * layers + 1),
                     "rms_norm": forwards,
                     "add_rms_norm": 2 * layers * forwards,
                     "decode_attention": steps * layers,
                     "prefill_attention": 2 * layers}
    assert residual_adds == [0]
    # A second block into the same cache: one launch a layer at the
    # cache's index, 8, where the first block ended.
    cache = init_cache(model, params, 2)
    offsets.clear()
    for start, block in ((0, ids), (8, ids[:, :5])):
        positions = start + torch.arange(block.shape[1])[None].expand(2, -1)
        with torch.inference_mode():
            llama.apply(model, params, block, positions, cache=cache)
    assert offsets == [(0, 8)] * layers + [(8, 5)] * layers
    assert calls["prefill_attention"] == 4 * layers
    assert calls["decode_attention"] == steps * layers
    assert residual_adds == [0]


def test_row_cumsum_scans_each_row_as_one_cumsum():
    probs = torch.softmax(torch.from_numpy(
        _normal(np.random.default_rng(0), 3, 2, 50)), -1)
    got = _row_cumsum(probs)
    assert got.shape == probs.shape
    for i in range(3):
        for j in range(2):
            assert torch.equal(got[i, j], torch.cumsum(probs[i, j], -1))


# -- the flash kernel's gradient -------------------------------------------


def _qkv(seed, l=64, h=4, d=16, kv_heads=None):
    rng = np.random.default_rng(seed)
    return (_normal(rng, 2, l, h, d), _normal(rng, 2, l, kv_heads or h, d),
            _normal(rng, 2, l, kv_heads or h, d))


def _jax_grads(q, k, v, **kw):
    def loss(q, k, v):
        return jnp.sum(jax_dense_attention(q, k, v, **kw) ** 2)
    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _port_grads(attention, q, k, v, **kw):
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    (attention(*ts, **kw) ** 2).sum().backward()
    return [t.grad for t in ts]


def _masked_case():
    mask = (np.arange(64)[None, :] < np.array([[40], [64]])).astype(np.int32)
    return mask


@pytest.mark.parametrize("case", ["causal", "masked"])
def test_flash_gradients_match_dense(case):
    """Twins of tests/test_flash_attention.py's gradient tests (causal,
    and a key mask) through the port's flash_attention: 5e-4."""
    q, k, v = _qkv(4 if case == "causal" else 7)
    kw = (dict(causal=True) if case == "causal"
          else dict(kv_segment_valid=_masked_case()))
    want = _jax_grads(q, k, v, **kw)
    if case == "masked":
        kw = dict(kv_segment_valid=torch.from_numpy(_masked_case()))
    got = _port_grads(fa.flash_attention, q, k, v, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4,
                                   rtol=5e-4)


@pytest.mark.parametrize("case", ["causal", "masked", "gqa"])
def test_flash_autograd_function_recomputes_the_plain_version(monkeypatch,
                                                              case):
    """The card's autograd.Function, with the kernel swapped for the
    plain version: its backward gives the plain version's gradients
    for q, k and v, and only for the inputs that want one."""
    monkeypatch.setattr(fa, "_launch",
                        lambda q, k, v, causal, scale, mask, q_offset:
                        fa.flash_attention_reference(
                            q, k, v, causal=causal, scale=scale,
                            kv_segment_valid=mask, q_offset=q_offset))
    q, k, v = _qkv(11, h=8 if case == "gqa" else 4,
                   kv_heads=2 if case == "gqa" else None)
    causal = case != "masked"
    mask = torch.from_numpy(_masked_case()) if case == "masked" else None
    got = _port_grads(lambda *t: fa._FlashAttention.apply(
        *t, causal, 0.25, mask), q, k, v)
    want = _port_grads(lambda *t: fa.flash_attention_reference(
        *t, causal=causal, scale=0.25, kv_segment_valid=mask), q, k, v)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    qt = torch.from_numpy(q).requires_grad_()
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    (fa._FlashAttention.apply(qt, kt, vt, causal, 0.25, mask) ** 2).sum() \
        .backward()
    assert qt.grad is not None and kt.grad is None and vt.grad is None


# -- the decode GEMM's launch plan ------------------------------------------
#
# Mirrored in Python (tests/test_torch_gpu.py holds the mirror against the
# built kernel's query): only the passes over W (grid y) may follow M.

#: llama3-8b's decode products: (dtype, K, N).
LLAMA_DECODE = ((torch.bfloat16, 4096, 4096), (torch.bfloat16, 4096, 1024),
                (torch.bfloat16, 4096, 14336), (torch.bfloat16, 14336, 4096),
                (torch.float32, 4096, 128256))


@pytest.mark.parametrize("dtype,k,n", LLAMA_DECODE)
def test_decode_gemm_plan_depends_on_m_only_through_the_passes(dtype, k, n):
    fixed = dg.launch_plan(dtype, 1, n, k)._replace(
        **dict.fromkeys(dg.M_FIELDS, 0))
    for m in range(1, 1025):
        plan = dg.launch_plan(dtype, m, n, k)
        assert plan._replace(**dict.fromkeys(dg.M_FIELDS, 0)) == fixed, m
    # One pass over W for every M up to 32, both dtypes (the fp32 head
    # too: a speculative verify's 4 · 5 rows read its W once).
    assert {dg.launch_plan(dtype, m, n, k).grid_y
            for m in range(1, 33)} == {1}
    assert dg.launch_plan(dtype, 33, n, k).grid_y == 2


@pytest.mark.parametrize("dtype,k,n", LLAMA_DECODE)
def test_decode_gemm_plan_fits_shared_memory_and_fills_the_card(dtype, k, n):
    plan = dg.launch_plan(dtype, 4, n, k)
    assert plan.smem_bytes <= 232448
    if dtype == torch.float32:
        # A slab of output columns a CTA wide enough that x's reads (up
        # to 32 rows of a K stage) stay within half of W's, and at least
        # two CTAs an SM.
        assert plan.tile_n >= 64 and plan.split == 1
        assert 2 * plan.rows_per_pass <= plan.tile_n
        assert 2 * (plan.smem_bytes + 1024) <= 233472
        assert plan.grid_x == -(-n // plan.tile_n)
    if dtype == torch.bfloat16:
        # About one wave, two CTAs an SM, each K tile range at least 2
        # stages long.
        assert 128 <= plan.grid_x <= 2 * dg.H100_SMS
        assert -(-k // dg.TILE_K) >= 2 * plan.split
        assert plan.split & (plan.split - 1) == 0
        assert plan.split <= dg.MAX_SPLIT


def test_decode_gemm_plan_refuses_other_dtypes():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dg.launch_plan(torch.float16, 4, 64, 64)
