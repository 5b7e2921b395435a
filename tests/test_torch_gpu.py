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

"""kubeflow_tpu_torch's CUDA kernels on the card, against their plain
versions, and the decode engine on the card against B=1 generate. Every
test here needs a GPU and skips without one.

The file imports neither JAX nor the reference, so it runs on a machine
with PyTorch and CUDA alone; tests/conftest.py imports JAX, so skip it::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.inference import prng
from kubeflow_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from kubeflow_tpu_torch.inference.generate import _sample_logits, generate
from kubeflow_tpu_torch.models.convert import init_params
from kubeflow_tpu_torch.models.llama import LayerCache, apply, llama_test
from kubeflow_tpu_torch.ops import bn_fused
from kubeflow_tpu_torch.ops import decode_attention as da
from kubeflow_tpu_torch.ops import decode_gemm as dg
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.ops import prefill_gemm as pg
from kubeflow_tpu_torch.ops import rms_norm as rn
from kubeflow_tpu_torch.ops.attention import dense_attention
from kubeflow_tpu_torch.ops.batch_norm import GhostBatchNorm

pytestmark = pytest.mark.gpu

#: bf16 outputs round to 8 mantissa bits (outputs are averages of
#: N(0, 1) values, below 1); fp32 differs only in summation order.
TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels need a GPU")
    return torch.device("cuda")


def _qkv(cuda, b, lq, lk, h, hkv, d, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(
        torch.randn(b, l, n, d, device=cuda, generator=gen).to(dtype)
        for l, n in ((lq, h), (lk, hkv), (lk, hkv)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,lq,lk,h,hkv,d,causal,masked", [
    (2, 200, 200, 8, 2, 64, True, False),    # ragged tail, GQA 4:1
    (1, 128, 128, 4, 4, 128, True, False),   # whole tiles, MHA
    (2, 96, 160, 4, 1, 64, False, True),     # Lq != Lk, key mask, MQA
    (2, 160, 96, 4, 2, 32, True, True),      # causal + mask, Lq > Lk
    (1, 1, 70, 4, 2, 64, False, False),      # one query row
])
def test_kernel_matches_plain_version(cuda, dtype, b, lq, lk, h, hkv, d,
                                      causal, masked):
    q, k, v = _qkv(cuda, b, lq, lk, h, hkv, d, dtype)
    mask = None
    if masked:
        lengths = torch.tensor([[lk // 2], [lk]], device=cuda)[:b]
        mask = (torch.arange(lk, device=cuda)[None, :] < lengths).to(
            torch.int32)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal, kv_segment_valid=mask)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = fa.flash_attention_reference(q, k, v, causal=causal,
                                       kv_segment_valid=mask)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_fully_masked_row_gives_zero(cuda):
    q, k, v = _qkv(cuda, 2, 64, 64, 4, 4, 64, torch.bfloat16)
    mask = torch.ones((2, 64), dtype=torch.int32, device=cuda)
    mask[1] = 0
    out = fa.flash_attention(q, k, v, kv_segment_valid=mask)
    assert torch.all(out[1] == 0)
    assert torch.isfinite(out).all()


def test_strided_views_are_read_in_place(cuda):
    # q/k/v as slices of one fused [B, L, H + 2 Hkv, D] projection: the
    # kernel reads them through their strides, no copy.
    fused = torch.randn(2, 100, 8 + 2 * 2, 64, device=cuda).bfloat16()
    q, k, v = fused[:, :, :8], fused[:, :, 8:10], fused[:, :, 10:]
    assert not q.is_contiguous()
    out = fa.flash_attention(q, k, v, causal=True)
    ref = fa.flash_attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,lq,lk,h,hkv,d,causal,masked", [
    (1, 128, 200, 4, 2, 128, False, False),  # Lk off the kv tile: TMA zero rows
    (2, 100, 333, 4, 4, 64, False, True),    # ragged Lk under a key mask
    (1, 1, 300, 4, 1, 128, True, False),     # one query row, causal
    (2, 300, 130, 8, 2, 128, True, False),   # Lq > Lk, causal
    (1, 129, 129, 2, 2, 128, True, False),   # one row past a q tile
])
def test_kernel_matches_plain_version_at_the_edges(cuda, dtype, b, lq, lk, h,
                                                   hkv, d, causal, masked):
    test_kernel_matches_plain_version(cuda, dtype, b, lq, lk, h, hkv, d,
                                      causal, masked)


@pytest.mark.parametrize("d", fa.HEAD_DIMS[torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_every_bf16_head_dim(cuda, d, causal):
    test_kernel_matches_plain_version(cuda, torch.bfloat16, 2, 200, 200, 4, 2,
                                      d, causal, True)


@pytest.mark.parametrize("d", fa.HEAD_DIMS[torch.bfloat16])
def test_fully_masked_row_gives_zero_at_every_head_dim(cuda, d):
    q, k, v = _qkv(cuda, 2, 130, 130, 4, 2, d, torch.bfloat16)
    mask = torch.ones((2, 130), dtype=torch.int32, device=cuda)
    mask[1] = 0
    for causal in (False, True):
        out = fa.flash_attention(q, k, v, causal=causal, kv_segment_valid=mask)
        assert torch.all(out[1] == 0)
        assert torch.isfinite(out).all()


@pytest.mark.parametrize("d", [64, 128])
def test_fused_projection_slices_through_the_tensor_maps(cuda, d):
    # q/k/v as slices of one fused [B, L, H + 2 Hkv, D] projection, GQA
    # 4:1 and a ragged length: the tensor maps carry the strides.
    fused = torch.randn(2, 300, 8 + 2 * 2, d, device=cuda).bfloat16()
    q, k, v = fused[:, :, :8], fused[:, :, 8:10], fused[:, :, 10:]
    out = fa.flash_attention(q, k, v, causal=True)
    ref = fa.flash_attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)


def test_no_keys_gives_zero_as_the_plain_version_does(cuda):
    q, k, v = _qkv(cuda, 1, 16, 0, 4, 2, 128, torch.bfloat16)
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_reference(q, k, v)
    assert torch.equal(out, ref) and torch.all(out == 0)


def test_same_bits_every_call(cuda):
    q, k, v = _qkv(cuda, 2, 1000, 1000, 8, 2, 128, torch.bfloat16)
    first = fa.flash_attention(q, k, v, causal=True)
    for _ in range(3):
        assert torch.equal(fa.flash_attention(q, k, v, causal=True), first)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scale", [0.0, -0.3])
def test_zero_and_negative_scale_match_the_plain_version(cuda, dtype, scale):
    # The max is taken over the scaled scores: a negative scale favours
    # the lowest score, and a zero scale weighs every valid key alike.
    q, k, v = _qkv(cuda, 2, 200, 200, 4, 2, 64, dtype)
    mask = (torch.arange(200, device=cuda)[None, :]
            < torch.tensor([[130], [200]], device=cuda)).to(torch.int32)
    out = fa.flash_attention(q, k, v, causal=True, scale=scale,
                             kv_segment_valid=mask)
    ref = fa.flash_attention_reference(q, k, v, causal=True, scale=scale,
                                       kv_segment_valid=mask)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_llama_test_bf16_forward_goes_through_the_kernel(cuda):
    # llama-test at its default dtype, bf16, has head_dim 16: its
    # cache-free forward launches the kernel once per layer. Logits
    # through the kernel vs through the plain attention, relative RMS
    # within twice the bf16 floor between two plain attentions.
    model = llama_test()
    assert (model.dtype, model.head_dim) == (torch.bfloat16, 16)
    params = init_params(model, seed=0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    ids = torch.randint(0, 512, (2, 300), device=cuda, generator=gen,
                        dtype=torch.int32)

    def logits(attention=None):
        m = model if attention is None else llama_test(
            attention_fn=functools.partial(attention, causal=True))
        with torch.inference_mode():
            return apply(m, params, ids)

    before = fa.flash_attention.launches
    out = logits()
    assert fa.flash_attention.launches == before + model.num_layers
    plain = logits(fa.flash_attention_reference)
    floor = _rel_rms(logits(dense_attention), plain)
    assert torch.isfinite(out).all()
    assert _rel_rms(out, plain) <= max(2 * floor, 1e-3)


def _rel_rms(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("bad", ["float16", "head_dim_8", "head_dim_512",
                                 "last_dim_strided", "heads", "mask_shape",
                                 "head_dim_96"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda, bad):
    q, k, v = _qkv(cuda, 1, 32, 32, 4, 2, 64, torch.bfloat16)
    mask = None
    if bad == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_dim_8":
        q, k, v = (t[..., :8] for t in (q, k, v))
    elif bad == "head_dim_512":
        q, k, v = (t.repeat(1, 1, 1, 8) for t in (q, k, v))
    elif bad == "head_dim_96":  # a multiple of 16, but not instantiated
        q, k, v = (torch.cat([t, t[..., :32]], dim=-1) for t in (q, k, v))
    elif bad == "last_dim_strided":
        q = q.transpose(1, 3).contiguous().transpose(1, 3)
    elif bad == "heads":
        k, v = k[:, :, :1].expand(1, 32, 3, 64), v[:, :, :1].expand(
            1, 32, 3, 64)
    elif bad == "mask_shape":
        mask = torch.ones((1, 31), dtype=torch.int32, device=cuda)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, kv_segment_valid=mask)
    assert fa.flash_attention.launches == before


#: BN kernel vs plain version: the statistics are fp32 sums in another
#: order; y may differ by one step of its type (2**-7 relative in bf16).
BN_Y_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


def _bn_inputs(cuda, m, c, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(m, c, device=cuda, generator=gen) * 2 + 0.5).to(dtype)
    return (x, torch.rand(c, device=cuda, generator=gen),
            torch.randn(c, device=cuda, generator=gen))


def _limit_slab(monkeypatch, x, slab_rows=None, coresident=None):
    """Make the wrapper plan x's launches with a slab of ``slab_rows``
    rows of a C tile (so the stream route, keeping a few rows, runs at
    small shapes) or with ``coresident`` blocks; None keeps the card's
    own figure."""
    lib = bn_fused._library()
    dtype, vec = bn_fused._DTYPES[x.dtype], bn_fused.vector_width(x)
    real_coresident, real_slab = bn_fused.device_limits(lib, x.device, dtype,
                                                        vec)
    slab = real_slab
    if slab_rows is not None:
        tx = bn_fused.launch_plan(x.shape[0], x.shape[1], vec,
                                  x.element_size(), coresident=1,
                                  slab_bytes=0).tx
        slab = slab_rows * min(tx * vec, x.shape[1]) * x.element_size()
    monkeypatch.setitem(bn_fused._limits, (x.device.index, dtype, vec),
                        (coresident or real_coresident, slab))
    monkeypatch.setattr(bn_fused, "_plans", {})  # plans of the real limits


#: The card's own limits, and a slab of 3 rows: the stream route with a
#: few kept rows even at small shapes.
ROUTES = {"card": None, "slab3": 3}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,c,stat_rows", [
    (50176, 64, None),     # C = 64: a warp spans four rows
    (12544, 2048, None),   # many C tiles
    (20000, 256, 3136),    # ghost statistics over the leading rows
    (10007, 99, None),     # prime M, C off the vector width: scalar path
    (1, 8, None),          # one row
    (4099, 256, 1),        # one stat row
    (4099, 256, 17),       # fewer stat rows than one block's share
    (4099, 256, 4099),     # every row a stat row, given explicitly
])
def test_bn_kernel_matches_plain_version(cuda, monkeypatch, route, dtype, m,
                                         c, stat_rows):
    x, scale, bias = _bn_inputs(cuda, m, c, dtype)
    _limit_slab(monkeypatch, x, ROUTES[route])
    before = bn_fused.fused_bn_train_forward.launches
    y, mean, var = bn_fused.fused_bn_train_forward(x, scale, bias,
                                                   stat_rows=stat_rows)
    torch.cuda.synchronize()
    assert bn_fused.fused_bn_train_forward.launches == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    y_ref, mean_ref, var_ref = bn_fused.reference_bn_train_forward(
        x, scale, bias, stat_rows=stat_rows)
    torch.testing.assert_close(mean, mean_ref, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(var, var_ref, atol=1e-4, rtol=1e-5)
    diff = (y.float() - y_ref.float()).abs()
    assert float(diff.max()) <= BN_Y_TOL[dtype] * max(
        1.0, float(y_ref.float().abs().max()))


def test_bn_both_routes_run_at_the_test_shapes(cuda, monkeypatch):
    x, _, _ = _bn_inputs(cuda, 20000, 256, torch.bfloat16)
    routes = {}
    for route, rows in ROUTES.items():
        _limit_slab(monkeypatch, x, rows)
        coresident, slab = bn_fused._limits[(x.device.index, 1, 8)]
        plan = bn_fused.launch_plan(20000, 256, 8, 2, coresident=coresident,
                                    slab_bytes=slab)
        routes[route] = (plan.route, plan.keep)
    assert routes == {"card": ("onchip", routes["card"][1]),
                      "slab3": ("stream", 3)}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("m,c,stat_rows", [(200704, 128, None),
                                           (50176, 256, None),
                                           (50176, 256, 6272)])
def test_bn_kernel_gives_the_same_bits_every_run(cuda, monkeypatch, route, m,
                                                 c, stat_rows):
    x, scale, bias = _bn_inputs(cuda, m, c, torch.bfloat16)
    _limit_slab(monkeypatch, x, ROUTES[route])
    first = bn_fused.fused_bn_train_forward(x, scale, bias,
                                            stat_rows=stat_rows)
    for _ in range(3):
        again = bn_fused.fused_bn_train_forward(x, scale, bias,
                                                stat_rows=stat_rows)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("stat_rows", [None, 64])
def test_bn_kernel_gradient_is_the_plain_versions(cuda, monkeypatch, route,
                                                  stat_rows):
    x, scale, bias = _bn_inputs(cuda, 256, 32, torch.float32)
    _limit_slab(monkeypatch, x, ROUTES[route])
    gy = torch.randn(256, 32, device=cuda)
    grads = []
    for fn in (bn_fused.fused_bn_train_forward,
               bn_fused.reference_bn_train_forward):
        leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
        y, mean, _ = fn(*leaves, stat_rows=stat_rows)
        (y * gy).sum().add(mean.sum()).backward()
        grads.append([t.grad for t in leaves])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_bn_grid_too_large_to_be_coresident_raises(cuda, monkeypatch):
    # Planned for four times the blocks the card holds at once: the
    # cooperative launch refuses it, and the wrapper raises (no hang).
    x, scale, bias = _bn_inputs(cuda, 802816, 64, torch.bfloat16)
    real = bn_fused.device_limits(bn_fused._library(), x.device, 1, 8)[0]
    _limit_slab(monkeypatch, x, coresident=4 * real)
    before = bn_fused.fused_bn_train_forward.launches
    with pytest.raises(RuntimeError, match="bn_forward launch"):
        bn_fused.fused_bn_train_forward(x, scale, bias)
    torch.cuda.synchronize()
    assert bn_fused.fused_bn_train_forward.launches == before


@pytest.mark.parametrize("bad", ["strided", "float16", "stat_rows"])
def test_bn_wrapper_raises_on_what_the_kernel_does_not_take(cuda, bad):
    x, scale, bias = _bn_inputs(cuda, 64, 16, torch.bfloat16)
    kw = {}
    if bad == "strided":
        x = x.t().contiguous().t()
    elif bad == "float16":
        x = x.half()
    elif bad == "stat_rows":
        kw["stat_rows"] = 65
    before = bn_fused.fused_bn_train_forward.launches
    with pytest.raises(ValueError):
        bn_fused.fused_bn_train_forward(x, scale, bias, **kw)
    assert bn_fused.fused_bn_train_forward.launches == before


def test_ghost_batch_norm_refuses_a_copy_on_the_card(cuda):
    bn = GhostBatchNorm(16, dtype="bfloat16", device=cuda)
    nchw = torch.zeros(2, 16, 4, 4, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="channels-last"):
        bn(nchw)
    y = bn(nchw.contiguous(memory_format=torch.channels_last))
    assert y.is_contiguous(memory_format=torch.channels_last)


# -- the continuous-batching engine on the card (llama-test bf16) ----------
#
# Twins of chip_smoke.py's engine phases at llama-test size: six requests
# of mixed prompts and budgets through a 4-slot engine (every stream its
# budget of in-vocab tokens, each first token B=1 generate's, the pool
# clean), and two of them through a 1-slot engine, token for token B=1.

ENGINE_PROMPTS = (30, 64, 7, 41, 20, 64)
ENGINE_BUDGETS = (12, 4, 12, 8, 12, 10)
ENGINE_SAMPLING = {"greedy": {"temperature": 0.0},
                   "sampled": {"temperature": 0.7, "top_k": 40,
                               "top_p": 0.9}}


def _engine_case(cuda, slots, sampling):
    cache = max(ENGINE_PROMPTS) + 16  # whole pages: one logical length
    model = llama_test(cache_size=cache)
    params = init_params(model, seed=0, device=cuda)
    engine = DecodeEngine(model, params, EngineConfig(
        max_new_tokens=max(ENGINE_BUDGETS),
        max_prompt_len=max(ENGINE_PROMPTS), num_slots=slots, page_size=16,
        slice_tokens=4, **sampling), device=cuda)
    rng = np.random.default_rng(0)
    requests = [(rng.integers(0, 512, n).astype(np.int32), b,
                 prng.PRNGKey(100 + i))
                for i, (n, b) in enumerate(zip(ENGINE_PROMPTS,
                                               ENGINE_BUDGETS))]
    return model, params, engine, requests


def _b1(model, params, engine, prompt, key, budget, sampling, cuda):
    width = engine._prompt_width(len(prompt))
    ids = np.zeros((1, width), np.int32)
    ids[0, width - len(prompt):] = prompt
    tokens, _ = generate(model, params, torch.from_numpy(ids).to(cuda),
                         max_new_tokens=budget, rng=key[None],
                         prompt_lengths=torch.tensor([len(prompt)],
                                                     device=cuda),
                         **sampling)
    return tokens[0].cpu().numpy()


@pytest.mark.parametrize("mode", sorted(ENGINE_SAMPLING))
def test_engine_four_slots_first_tokens_and_pool(cuda, mode):
    sampling = ENGINE_SAMPLING[mode]
    model, params, engine, requests = _engine_case(cuda, 4, sampling)
    try:
        streams = [engine.submit(p, rng=k, max_new_tokens=b)
                   for p, b, k in requests]
        results = [s.result(timeout=300) for s in streams]
        for (p, b, k), got in zip(requests, results):
            want = _b1(model, params, engine, p, k, b, sampling, cuda)
            assert got.shape == (b,) and ((got >= 0) & (got < 512)).all()
            assert got[0] == want[0]
        stats = engine.stats()
        assert stats["admitted"] == 6 and stats["retired"] == {"budget": 6}
        assert stats["free_pages"] == stats["total_pages"]
        engine.kv.allocator.check_invariants()
    finally:
        engine.stop()


@pytest.mark.parametrize("mode", sorted(ENGINE_SAMPLING))
def test_engine_one_slot_equals_b1_generate(cuda, mode):
    sampling = ENGINE_SAMPLING[mode]
    model, params, engine, requests = _engine_case(cuda, 1, sampling)
    try:
        for p, b, k in (requests[0], requests[2]):
            got = engine.submit(p, rng=k, max_new_tokens=b).result(
                timeout=300)
            want = _b1(model, params, engine, p, k, b, sampling, cuda)
            np.testing.assert_array_equal(got, want)
    finally:
        engine.stop()


@pytest.mark.parametrize("mode", sorted(ENGINE_SAMPLING))
def test_engine_four_slots_equal_b1_generate(cuda, mode):
    """The engine's contract on the card: every stream of the 4-slot
    mix equals B=1 generate, bitwise (the decode step's kernels give a
    row its bits at any row count)."""
    sampling = ENGINE_SAMPLING[mode]
    model, params, engine, requests = _engine_case(cuda, 4, sampling)
    try:
        streams = [engine.submit(p, rng=k, max_new_tokens=b)
                   for p, b, k in requests]
        for (p, b, k), s in zip(requests, streams):
            np.testing.assert_array_equal(
                s.result(timeout=300),
                _b1(model, params, engine, p, k, b, sampling, cuda))
    finally:
        engine.stop()


def test_prefix_engine_on_the_card_hits_and_drains(cuda):
    """The prefix lane on the card: a cold request, then hits on its
    full blocks and a forked boundary page; every stream its budget of
    in-vocab tokens, the hit/miss counts, and a pool that drains."""
    model = llama_test(cache_size=96)
    params = init_params(model, seed=0, device=cuda)
    engine = DecodeEngine(model, params, EngineConfig(
        max_new_tokens=8, max_prompt_len=64, num_slots=4, page_size=16,
        slice_tokens=4, prefix_cache=True), device=cuda)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 512, 40).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 512, n).astype(
        np.int32)]) for n in (5, 12, 3, 20)]
    try:
        first = engine.submit(prompts[0], rng=prng.PRNGKey(0))
        out = [first.result(timeout=300)]
        out += [engine.submit(p, rng=prng.PRNGKey(i + 1)).result(timeout=300)
                for i, p in enumerate(prompts[1:])]
        assert all(o.shape == (8,) and ((o >= 0) & (o < 512)).all()
                   for o in out)
        st = engine.stats()
        assert st["prefix_cache"]["hits"] == 3
        assert st["prefix_cache"]["misses"] == 1
        engine.kv.allocator.check_invariants()
        engine.prefix.check_invariants()
        engine.clear_prefix_cache()
        assert engine.stats()["free_pages"] == engine.stats()["total_pages"]
    finally:
        engine.stop()


# -- the decode step's kernels ---------------------------------------------
#
# Each against its plain twin: one step of its output type (2**-7 of
# max(1, |y|) in bf16, 1e-5 of it in fp32: fp32 sums in another order,
# then one rounding), the same bits on a second call, and the rows of a
# batch equal to each row computed alone, bit for bit.

STEP = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
ROW_COUNTS = (1, 2, 3, 4, 8, 16)
#: The decode GEMM also serves a speculative verify's slots·(k + 1) rows
#: (4 · 5 = 20) in one pass over W, up to 32.
GEMM_ROW_COUNTS = ROW_COUNTS + (20, 32)
#: Past 32 rows the kernel takes a second pass over W.
GEMM_PASS_ROWS = GEMM_ROW_COUNTS + (40,)


def _assert_within_a_step(got, want, dtype):
    tol = STEP[dtype] * max(1.0, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (err, tol)


def _rows_alone_equal(fn, xs, *rest):
    whole = fn(xs, *rest)
    for i in range(xs.shape[0]):
        assert torch.equal(fn(xs[i:i + 1], *rest), whole[i:i + 1]), i


@pytest.mark.parametrize("dtype,k,n", [
    (torch.bfloat16, 4096, 1024), (torch.bfloat16, 512, 2000),
    (torch.bfloat16, 64, 128), (torch.float32, 4096, 5000),
    (torch.float32, 64, 512)])
def test_decode_gemm_matches_plain_and_rows_are_row_count_free(
        cuda, dtype, k, n):
    gen = torch.Generator(device=cuda).manual_seed(0)
    w = (torch.randn(n, k, device=cuda, generator=gen) * 0.02).to(dtype)
    x = torch.randn(max(GEMM_PASS_ROWS), 1, k, device=cuda,
                    generator=gen).to(dtype)
    before = dg.decode_linear.launches
    for m in GEMM_PASS_ROWS:
        got = dg.decode_linear(x[:m], w)
        torch.cuda.synchronize()
        _assert_within_a_step(got, dg.decode_linear_reference(x[:m], w),
                              dtype)
        assert torch.equal(dg.decode_linear(x[:m], w), got)
        _rows_alone_equal(dg.decode_linear, x[:m], w)
    assert dg.decode_linear.launches > before


def test_decode_gemm_plan_mirror_is_the_kernels(cuda):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for dtype, k, n in ((torch.bfloat16, 4096, 4096),
                        (torch.bfloat16, 4096, 1024),
                        (torch.bfloat16, 4096, 14336),
                        (torch.bfloat16, 14336, 4096),
                        (torch.bfloat16, 64, 128), (torch.bfloat16, 512, 2000),
                        (torch.float32, 4096, 128256)):
        for m in (1, 4, 20, 32, 33, 100):
            assert dg.kernel_plan(dtype, m, n, k, sms) == \
                dg.launch_plan(dtype, m, n, k, sms), (dtype, m, n, k)


def test_decode_gemm_raises_where_a_gradient_is_wanted(cuda):
    w = torch.randn(8, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        dg.decode_linear(torch.randn(2, 64, device=cuda), w)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 4096),
                                     (torch.bfloat16, 64),
                                     (torch.float32, 4096),
                                     (torch.float32, 64)])
def test_rms_norm_matches_plain_and_rows_are_row_count_free(cuda, dtype, d):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(16, 1, d, device=cuda, generator=gen) * 2).to(dtype)
    scale = (1 + 0.1 * torch.randn(d, device=cuda, generator=gen)).to(dtype)
    for m in ROW_COUNTS:
        got = rn.rms_norm(x[:m], scale, 1e-5)
        torch.cuda.synchronize()
        _assert_within_a_step(got, rn.rms_norm_reference(x[:m], scale, 1e-5),
                              dtype)
        assert torch.equal(rn.rms_norm(x[:m], scale, 1e-5), got)
        _rows_alone_equal(lambda t: rn.rms_norm(t, scale, 1e-5), x[:m])


def test_rms_norm_gradient_is_the_plain_versions(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(8, 64, device=cuda, generator=gen)
    scale = 1 + 0.1 * torch.randn(64, device=cuda, generator=gen)
    gy = torch.randn(8, 64, device=cuda, generator=gen)
    grads = []
    for fn in (rn.rms_norm, rn.rms_norm_reference):
        leaves = [t.clone().requires_grad_(True) for t in (x, scale)]
        (fn(*leaves, 1e-5) * gy).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype,h,hkv,s,d", [
    (torch.bfloat16, 32, 8, 544, 128), (torch.bfloat16, 4, 2, 80, 16),
    (torch.float32, 8, 2, 200, 64), (torch.float32, 4, 4, 33, 16),
    (torch.bfloat16, 32, 8, 8192, 128), (torch.float32, 16, 2, 700, 256)])
def test_decode_attention_matches_plain_and_rows_are_row_count_free(
        cuda, dtype, h, hkv, s, d):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(16, 1, h, d, device=cuda, generator=gen).to(dtype)
    k = torch.randn(16, s, hkv, d, device=cuda, generator=gen).to(dtype)
    v = torch.randn(16, s, hkv, d, device=cuda, generator=gen).to(dtype)
    pos = torch.arange(s, device=cuda)
    start = torch.randint(0, s, (16,), device=cuda, generator=gen)
    pad = torch.minimum(torch.randint(0, 8, (16,), device=cuda,
                                      generator=gen), start)
    valid = (pos[None] <= start[:, None]) & (pos[None] >= pad[:, None])
    valid[3] = False  # a fully masked row gives 0
    tol = TOL[dtype]
    for m in ROW_COUNTS:
        got = da.decode_attention(q[:m], k[:m], v[:m], valid[:m])
        torch.cuda.synchronize()
        want = da.dense_attention(q[:m], k[:m], v[:m],
                                  kv_segment_valid=valid[:m])
        assert float((got.float() - want.float()).abs().max()) <= tol
        assert torch.equal(da.decode_attention(q[:m], k[:m], v[:m],
                                               valid[:m]), got)
        for i in range(m):
            assert torch.equal(da.decode_attention(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], valid[i:i + 1]),
                got[i:i + 1]), (m, i)
    assert not da.decode_attention(q, k, v, valid)[3].any()


def test_decode_attention_smem_mirror_is_the_kernels(cuda):
    for h, hkv, s, d in ((32, 8, 544, 128), (4, 2, 80, 16), (8, 8, 9000, 64),
                         (32, 8, 8192, 128), (32, 8, 100000, 128),
                         (8, 1, 30000, 256)):
        for elem in (2, 4):
            assert da.smem_bytes(h, hkv, s, d, elem) == \
                da.kernel_smem_bytes(h, hkv, s, d, elem)
        assert da.splits(s) == da.kernel_splits(s)


def _s_ceiling(h, hkv, d):
    """The longest bf16 cache whose CTA share fits."""
    lo, hi = 1, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        fits = (da.smem_bytes(h, hkv, mid, d, 2) + da.STATIC_SMEM_BYTES
                <= fa.MAX_SMEM_BYTES)
        lo, hi = (mid, hi) if fits else (lo, mid - 1)
    return lo


def test_decode_attention_runs_at_its_s_ceiling(cuda):
    """llama3-8b's heads at the longest cache a CTA's shared memory
    holds: the kernel launches, holds against the plain version and
    gives a row its bits alone; one key more is refused."""
    s = _s_ceiling(32, 8, 128)
    assert s > 8 * 8192
    gen = torch.Generator(device=cuda).manual_seed(12)
    q = torch.randn(2, 1, 32, 128, device=cuda, generator=gen).to(
        torch.bfloat16)
    k = torch.randn(2, s, 8, 128, device=cuda, generator=gen).to(
        torch.bfloat16)
    v = torch.randn(2, s, 8, 128, device=cuda, generator=gen).to(
        torch.bfloat16)
    valid = torch.arange(s, device=cuda)[None] < torch.tensor(
        [[s], [s - 1000]], device=cuda)
    got = da.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    want = da.dense_attention(q, k, v, kv_segment_valid=valid)
    assert float((got.float() - want.float()).abs().max()) <= \
        TOL[torch.bfloat16]
    assert torch.equal(da.decode_attention(q[1:], k[1:], v[1:], valid[1:]),
                       got[1:])
    longer = k[:1, :1].expand(1, s + 1, 8, 128)
    with pytest.raises(ValueError, match="shared memory"):
        da.decode_attention(q[:1], longer, longer,
                            torch.ones(1, s + 1, dtype=torch.bool,
                                       device=cuda))


def test_decode_attention_reads_an_expanded_mask_in_place(cuda):
    """generate's scalar path hands one validity row expanded over the
    batch (batch stride 0)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(3, 1, 4, 16, device=cuda, generator=gen)
    k = torch.randn(3, 50, 2, 16, device=cuda, generator=gen)
    v = torch.randn(3, 50, 2, 16, device=cuda, generator=gen)
    valid = (torch.arange(50, device=cuda) < 31)[None].expand(3, -1)
    got = da.decode_attention(q, k, v, valid)
    want = da.dense_attention(q, k, v, kv_segment_valid=valid)
    assert float((got - want).abs().max()) <= TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_llama_test_decode_step_rows_equal_each_row_alone(cuda, dtype):
    """A llama-test decode step at M = 4 (rows at different cache
    positions, one left-padded) gives each row the logits it gets at
    M = 1, bit for bit, through the decode kernels."""
    model = llama_test(dtype=dtype, cache_size=64)
    params = init_params(model, seed=0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    shape = (4, 64, model.num_kv_heads, model.head_dim)
    caches = [(torch.randn(shape, device=cuda, generator=gen).to(dtype),
               torch.randn(shape, device=cuda, generator=gen).to(dtype))
              for _ in range(model.num_layers)]
    tok = torch.randint(0, 512, (4, 1), device=cuda, generator=gen)
    start = torch.tensor([10, 63, 31, 5], device=cuda)
    pad = torch.tensor([0, 0, 4, 0], device=cuda)
    counts = (dg.decode_linear.launches, rn.rms_norm.launches,
              da.decode_attention.launches)

    def step(rows):
        cache = [LayerCache(k[rows].clone(), v[rows].clone())
                 for k, v in caches]
        with torch.inference_mode():
            return apply(model, params, tok[rows],
                         (start - pad)[rows, None], pad_lengths=pad[rows],
                         decode_positions=start[rows], cache=cache)

    whole = step(slice(None))
    for i in range(4):
        assert torch.equal(step(slice(i, i + 1)), whole[i:i + 1]), i
    layers = model.num_layers
    assert (dg.decode_linear.launches - counts[0],
            rn.rms_norm.launches - counts[1],
            da.decode_attention.launches - counts[2]) == (
        5 * (7 * layers + 1), 5 * (2 * layers + 1), 5 * layers)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_kernel_gradient_is_the_plain_versions(cuda, dtype, masked):
    """dq, dk and dv through the kernel's autograd.Function against the
    plain version's autograd: 1e-2 in bf16 (both backwards recompute in
    bf16 from one forward that rounds apart), 5e-4 in fp32."""
    q, k, v = _qkv(cuda, 2, 96, 96, 8, 2, 64, dtype, seed=6)
    mask = None
    if masked:
        mask = (torch.arange(96, device=cuda)[None, :] < torch.tensor(
            [[60], [96]], device=cuda)).to(torch.int32)
    gout = torch.randn(2, 96, 8, 64, device=cuda).to(dtype)
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_reference):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, causal=not masked, kv_segment_valid=mask)
        (out.float() * gout.float()).sum().backward()
        grads.append([t.grad for t in leaves])
    tol = 1e-2 if dtype == torch.bfloat16 else 5e-4
    for got, ref in zip(*grads):
        assert got is not None
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol)


# -- the prefill GEMM --------------------------------------------------------
#
# Against its plain version (F.linear) to one bf16 step, the same bits on
# a second call, and rows whose bits do not depend on the block width: the
# last and first M rows of a 512-row block, computed alone in a block of
# M rows, equal the same rows of the 512-row block, and each half of a
# 1024-row block (generate's [2, 512] prefill; at k/v more output tiles
# than the card holds clusters) equals that half alone.

PREFILL_WIDTHS = (1, 2, 20, 128, 140, 256, 512)


@pytest.mark.parametrize("k,n", [(4096, 1024), (512, 2000), (64, 128),
                                 (72, 40), (1024, 33), (256, 2350),
                                 (264, 8200)])
def test_prefill_gemm_matches_plain_and_rows_are_width_free(cuda, k, n):
    gen = torch.Generator(device=cuda).manual_seed(13)
    w = (torch.randn(n, k, device=cuda, generator=gen) * 0.02).to(
        torch.bfloat16)
    x_main = torch.randn(1024, k, device=cuda, generator=gen).to(
        torch.bfloat16)
    x = x_main[:512]
    before = pg.prefill_linear.launches
    for block in (x, x_main):
        whole = pg.prefill_linear(block, w)
        torch.cuda.synchronize()
        _assert_within_a_step(whole, pg.prefill_linear_reference(block, w),
                              torch.bfloat16)
        assert torch.equal(pg.prefill_linear(block, w), whole)
    got = pg.prefill_linear(x, w)
    assert torch.equal(whole[:512], got)
    assert torch.equal(pg.prefill_linear(x_main[512:], w), whole[512:])
    for m in PREFILL_WIDTHS:
        assert torch.equal(pg.prefill_linear(x[512 - m:].contiguous(), w),
                           got[512 - m:]), m
        assert torch.equal(pg.prefill_linear(x[:m], w), got[:m]), m
    # generate's [B, L, K] block: rows as the flat block's.
    assert torch.equal(pg.prefill_linear(x.reshape(2, 256, k), w),
                       got.reshape(2, 256, n))
    assert torch.equal(pg.prefill_linear(x_main.reshape(2, 512, k), w),
                       whole.reshape(2, 512, n))
    assert pg.prefill_linear.launches > before


def test_prefill_gemm_plan_mirror_is_the_kernels(cuda):
    for k, n in ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                 (512, 2000), (64, 128), (72, 40), (1024, 33), (256, 2350),
                 (264, 8200)):
        clusters = pg.kernel_max_clusters(n, k)
        plan = pg.launch_plan(1, n, k)
        assert 0 < clusters <= pg.H100_SMS // (plan.split * plan.share)
        for m in (1, 2, 20, 128, 140, 512, 1024):
            assert pg.kernel_plan(m, n, k, clusters) == \
                pg.launch_plan(m, n, k, clusters), (m, n, k)


@pytest.mark.parametrize("bad", ["float32", "k_not_8", "w_strided",
                                 "devices", "gradient"])
def test_prefill_gemm_wrapper_raises_on_what_the_kernel_does_not_take(
        cuda, bad):
    x = torch.randn(4, 64, device=cuda).to(torch.bfloat16)
    w = torch.randn(32, 64, device=cuda).to(torch.bfloat16)
    error, match = ValueError, None
    if bad == "float32":
        x, w, match = x.float(), w.float(), "bfloat16"
    elif bad == "k_not_8":
        x, w, match = x[:, :60], w[:, :60].contiguous(), "multiple of 8"
    elif bad == "w_strided":
        w, match = torch.randn(64, 32, device=cuda).to(torch.bfloat16).t(), \
            "contiguous"
    elif bad == "devices":
        w, match = w.cpu(), "one device"
    else:
        w, error, match = w.requires_grad_(True), RuntimeError, "no gradient"
    before = pg.prefill_linear.launches
    with pytest.raises(error, match=match):
        pg.prefill_linear(x, w)
    assert pg.prefill_linear.launches == before


@pytest.mark.parametrize("mode", sorted(ENGINE_SAMPLING))
def test_prefix_hits_equal_their_cold_runs_on_the_card(cuda, mode):
    """llama-test bf16 through the prefix lane: a cold request, then hits
    on its full blocks and a copy-on-write fork of its boundary page,
    with tails of several widths; each hit stream equals the same
    request run cold (the cache cleared), and every stream equals B=1
    generate of the unpadded prompt."""
    sampling = ENGINE_SAMPLING[mode]
    model = llama_test(cache_size=96)
    params = init_params(model, seed=0, device=cuda)
    engine = DecodeEngine(model, params, EngineConfig(
        max_new_tokens=8, max_prompt_len=64, num_slots=4, page_size=16,
        slice_tokens=4, prefix_cache=True, **sampling), device=cuda)
    rng = np.random.default_rng(2)
    shared = rng.integers(0, 512, 40).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 512, n).astype(
        np.int32)]) for n in (5, 12, 3, 20, 1)] + [shared[:36]]
    keys = [prng.PRNGKey(400 + i) for i in range(len(prompts))]
    before = pg.prefill_linear.launches
    try:
        cold = engine.submit(prompts[0], rng=keys[0]).result(timeout=300)
        streams = [engine.submit(p, rng=k)
                   for p, k in zip(prompts[1:], keys[1:])]
        hits = [s.result(timeout=300) for s in streams]
        px = engine.stats()["prefix_cache"]
        assert px["hits"] == len(prompts) - 1 and px["misses"] == 1, px
        # A match past the 32 tokens of the two full blocks: the forks.
        assert px["saved_prefill_tokens"] % 16, px
        assert pg.prefill_linear.launches - before == \
            7 * model.num_layers * len(prompts)
        recold = []
        for p, k in zip(prompts[1:], keys[1:]):
            engine.clear_prefix_cache()
            recold.append(engine.submit(p, rng=k).result(timeout=300))
        engine.clear_prefix_cache()
        assert engine.stats()["free_pages"] == engine.stats()["total_pages"]
        for i, (hit, again) in enumerate(zip(hits, recold)):
            np.testing.assert_array_equal(hit, again, err_msg=f"hit {i}")
        for i, (p, k, got) in enumerate(zip(prompts, keys, [cold] + hits)):
            want, _ = generate(model, params, torch.from_numpy(p[None]).to(
                cuda), max_new_tokens=8, rng=k[None],
                prompt_lengths=torch.tensor([len(p)], device=cuda),
                **sampling)
            np.testing.assert_array_equal(got, want[0].cpu().numpy(),
                                          err_msg=f"request {i}")
    finally:
        engine.stop()


# -- speculative decoding and the fp32 route on the card -------------------


def test_fp32_route_rows_equal_each_row_alone_at_every_m(cuda):
    """The decode GEMM's fp32 route (the lm_head's) at every M from 1 to
    40: within 1e-5·max(1, |y|) of its plain version, and every row the
    bits it has alone, so a verify's rows (slots·(k + 1)) are a decode
    step's; one pass over W up to 32 rows, a second past it."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    k, n = 1024, 3000
    w = torch.randn(n, k, device=cuda, generator=gen) * 0.02
    x = torch.randn(40, k, device=cuda, generator=gen)
    alone = torch.cat([dg.decode_linear(x[i:i + 1], w) for i in range(40)])
    _assert_within_a_step(alone, dg.decode_linear_reference(x, w),
                          torch.float32)
    for m in range(1, 41):
        assert torch.equal(dg.decode_linear(x[:m], w), alone[:m]), m
        assert dg.launch_plan(torch.float32, m, n, k).grid_y == \
            (1 if m <= 32 else 2)


@pytest.mark.parametrize("mode", sorted(ENGINE_SAMPLING))
def test_verify_rows_equal_the_one_token_steps(cuda, mode):
    """llama-test bf16 with its fp32 head: a verify forward of 4 rows ×
    5 tokens (``decode_positions``, one query at a time, every linear on
    the decode GEMM at M = 20) gives column j the logits of the one-token
    decode step at ``start + j``, bit for bit, and samples the same
    token from them."""
    model = llama_test(cache_size=64)
    params = init_params(model, seed=0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    shape = (4, 64, model.num_kv_heads, model.head_dim)
    caches = [(torch.randn(shape, device=cuda, generator=gen).to(
        torch.bfloat16), torch.randn(shape, device=cuda, generator=gen).to(
        torch.bfloat16)) for _ in range(model.num_layers)]
    block = torch.randint(0, 512, (4, 5), device=cuda, generator=gen)
    start = torch.tensor([10, 58, 31, 5], device=cuda)
    pad = torch.tensor([0, 0, 4, 0], device=cuda)
    positions = (start - pad)[:, None] + torch.arange(5, device=cuda)[None]

    def fresh():
        return [LayerCache(k.clone(), v.clone()) for k, v in caches]

    before = (dg.decode_linear.launches, pg.prefill_linear.launches)
    with torch.inference_mode():
        verify = apply(model, params, block, positions, pad_lengths=pad,
                       decode_positions=start, cache=fresh())
        cache = fresh()
        steps = torch.cat([apply(
            model, params, block[:, j:j + 1], positions[:, j:j + 1],
            pad_lengths=pad, decode_positions=start + j, cache=cache)
            for j in range(5)], dim=1)
    assert torch.equal(verify, steps)
    assert dg.decode_linear.launches - before[0] == 6 * (
        7 * model.num_layers + 1)
    assert pg.prefill_linear.launches == before[1]
    sampling = ENGINE_SAMPLING[mode]
    keys = torch.from_numpy(np.stack([prng.PRNGKey(i) for i in range(4)])
                            .astype(np.int64)).to(cuda)
    for j in range(5):
        assert torch.equal(
            _sample_logits(verify[:, j].contiguous(), keys,
                           sampling["temperature"], sampling.get("top_k"),
                           sampling.get("top_p")),
            _sample_logits(steps[:, j], keys, sampling["temperature"],
                           sampling.get("top_k"), sampling.get("top_p")))


@pytest.mark.parametrize("mode", sorted(ENGINE_SAMPLING))
def test_strong_draft_engine_equals_vanilla_on_the_card(cuda, mode):
    """The engine mix at llama-test size through a speculative engine
    whose draft is the model itself (k = 4): every stream equals the
    vanilla engine's, the acceptance is high, and the pool drains."""
    sampling = ENGINE_SAMPLING[mode]
    model, params, vanilla, requests = _engine_case(cuda, 4, sampling)
    spec = DecodeEngine(model, params, EngineConfig(
        max_new_tokens=max(ENGINE_BUDGETS),
        max_prompt_len=max(ENGINE_PROMPTS), num_slots=4, page_size=16,
        slice_tokens=4, speculate_tokens=4, **sampling), device=cuda,
        draft_model=model, draft_params=params)
    try:
        out = {}
        for name, engine in (("vanilla", vanilla), ("spec", spec)):
            streams = [engine.submit(p, rng=k, max_new_tokens=b)
                       for p, b, k in requests]
            out[name] = [s.result(timeout=300) for s in streams]
        for i, (a, b) in enumerate(zip(out["spec"], out["vanilla"])):
            np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
        stats = spec.stats()
        assert stats["spec"]["rounds"] > 0
        assert stats["spec"]["acceptance_rate"] > 0.5, stats["spec"]
        assert stats["free_pages"] == stats["total_pages"]
        spec.kv.allocator.check_invariants()
    finally:
        vanilla.stop()
        spec.stop()


#: A prefill block's rows against the same rows in blocks of these widths
#: (32 and below: a hit's tail buckets and short chunks; 64, 128: the
#: chunk widths and a whole q tile; 129: across a q tile's edge).
PREFILL_WIDTHS = (1, 2, 4, 8, 16, 32, 64, 128, 129)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefill_attention_rows_are_width_free(cuda, dtype):
    """A cache prefill's attention, one flash launch for the block at its
    offset (37, 165: not multiples of a tile): within flash's tolerance
    of the block's plain causal attention, and every query's output the
    same bits in a block of any width at any offset (a chunk, a hit's
    tail, the one-shot block), for rows with and without a left pad."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    b, l, s, h, hkv, d = 2, 260, 448, 8, 2, 64
    q = torch.randn(b, l, h, d, device=cuda, generator=gen).to(dtype)
    k = torch.randn(b, s, hkv, d, device=cuda, generator=gen).to(dtype)
    v = torch.randn(b, s, hkv, d, device=cuda, generator=gen).to(dtype)
    pos = torch.arange(s, device=cuda)[None, :]
    pads = torch.tensor([[0], [5]], device=cuda)
    for start in (37, 165):
        valid = (pos < start + l) & (pos >= pads)
        before = fa.flash_attention.launches
        whole = fa.prefill_attention(q, k, v, start, valid)
        assert fa.flash_attention.launches == before + 1
        want = dense_attention(q, k, v, causal=True, q_offset=start,
                               kv_offset=0, kv_segment_valid=valid)
        assert float((whole.float() - want.float()).abs().max()) <= \
            TOL[dtype]
        for width in PREFILL_WIDTHS:
            for lo in range(0, l, width):
                hi = min(l, lo + width)
                # The validity the engine builds for the narrower block.
                part_valid = (pos < start + hi) & (pos >= pads)
                part = fa.prefill_attention(q[:, lo:hi].contiguous(), k, v,
                                            start + lo, part_valid)
                assert torch.equal(part, whole[:, lo:hi]), (start, width,
                                                            lo)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_offset_0_is_the_call_without_one(cuda, dtype):
    """``q_offset=0`` is today's kernel: the bits of a call without the
    argument, causal and not, with a key mask, at Lq = Lk and Lq < Lk
    (predict and classify do not change)."""
    for b, lq, lk, causal, masked in ((2, 200, 200, True, False),
                                      (1, 96, 160, True, True),
                                      (2, 96, 160, False, True)):
        q, k, v = _qkv(cuda, b, lq, lk, 8, 2, 64, dtype, seed=lq + lk)
        mask = None
        if masked:
            mask = (torch.arange(lk, device=cuda)[None, :] < torch.tensor(
                [[lk - 30], [lk]], device=cuda)[:b]).to(torch.int32)
        plain = fa.flash_attention(q, k, v, causal=causal,
                                   kv_segment_valid=mask)
        assert torch.equal(fa.flash_attention(
            q, k, v, causal=causal, kv_segment_valid=mask, q_offset=0),
            plain)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 256),
                                     (torch.bfloat16, 32),
                                     (torch.float32, 64)])
def test_flash_at_an_offset_matches_plain_version(cuda, dtype, d):
    """The kernel at query offsets (GQA 4:1, left-padded validity, a
    block ending before the cache) against its plain version and
    dense_attention: flash's tolerance; the same bits on a second call."""
    b, l, s = 2, 150, 700
    q, k, v = _qkv(cuda, b, l, s, 8, 2, d, dtype, seed=d)
    pos = torch.arange(s, device=cuda)[None, :]
    for start in (0, 131, 448):
        valid = (pos < start + l) & (pos >= torch.tensor([[0], [9]],
                                                         device=cuda))
        got = fa.flash_attention(q, k, v, causal=True, q_offset=start,
                                 kv_segment_valid=valid)
        for ref in (fa.flash_attention_reference(
                        q, k, v, causal=True, q_offset=start,
                        kv_segment_valid=valid),
                    dense_attention(q, k, v, causal=True, q_offset=start,
                                    kv_offset=0, kv_segment_valid=valid)):
            assert float((got.float() - ref.float()).abs().max()) <= \
                TOL[dtype], start
        assert torch.equal(fa.flash_attention(
            q, k, v, causal=True, q_offset=start, kv_segment_valid=valid),
            got)


def test_flash_kv_tiles_mirror_is_the_kernels(cuda):
    """launch_plan's kv tiles per q tile equal the built kernel's own
    figure at offsets, widths and both routes."""
    for dtype, dims in fa.HEAD_DIMS.items():
        for d in dims:
            for lq, lk, causal, offset in ((200, 800, True, 448),
                                           (129, 400, True, 37),
                                           (2048, 2048, True, 0),
                                           (96, 160, False, 0),
                                           (1, 544, True, 300)):
                plan = fa.launch_plan(dtype, d, lq, lk=lk, causal=causal,
                                      q_offset=offset)
                assert plan.kv_tiles == tuple(
                    fa.kernel_kv_tiles(dtype, d, lq, lk, causal, offset, i)
                    for i in range(plan.grid[1])), (dtype, d, lq, offset)


def test_prefill_attention_raises_where_the_kernel_does_not_go(cuda):
    """No quiet route back: a CUDA block the kernel refuses (a head dim
    it has no instantiation for, an offset past the cache) raises and
    launches nothing."""
    q = torch.zeros(1, 8, 4, 48, dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros(1, 32, 2, 48, dtype=torch.bfloat16, device=cuda)
    valid = torch.ones(1, 32, dtype=torch.bool, device=cuda)
    before = (fa.flash_attention.launches, da.decode_attention.launches)
    with pytest.raises(ValueError, match="head_dim"):
        fa.prefill_attention(q, kv, kv, 4, valid)
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros(1, 32, 2, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="within Lk"):
        fa.prefill_attention(q, kv, kv, 25, valid)
    assert (fa.flash_attention.launches,
            da.decode_attention.launches) == before


# -- KV handoff, the host tier and fleet blocks on the card ----------------
#
# These carry bytes the cache already holds, so they hold bit for bit:
# an adopted stream equals the local one and B=1, a re-adopted or
# imported hit equals its cold run.


def _blob_round_trip(handoff):
    from kubeflow_tpu_torch.serving import wire

    return wire.decode_kv_handoff(wire.encode_kv_handoff("m", 1, handoff),
                                  model="m", version=1)


@pytest.mark.parametrize("mode", sorted(ENGINE_SAMPLING))
def test_classic_handoff_equals_local_and_b1_on_the_card(cuda, mode):
    sampling = ENGINE_SAMPLING[mode]
    model, params, local, requests = _engine_case(cuda, 4, sampling)
    adopter = DecodeEngine(model, params, local.config, name="adopter",
                           device=cuda)
    try:
        for p, b, k in requests:
            handoff = _blob_round_trip(local.run_prefill(
                p, rng=k, max_new_tokens=b))
            got = adopter.submit(handoff=handoff).result(timeout=300)
            np.testing.assert_array_equal(
                got, local.submit(p, rng=k, max_new_tokens=b).result(
                    timeout=300))
            np.testing.assert_array_equal(
                got, _b1(model, params, local, p, k, b, sampling, cuda))
        st = adopter.stats()
        assert st["retired"] == {"budget": len(requests)}
        assert st["free_pages"] == st["total_pages"]
        adopter.kv.allocator.check_invariants()
    finally:
        local.stop()
        adopter.stop()


def _prefix_case(cuda, sampling, **kw):
    model = llama_test(cache_size=96)
    params = init_params(model, seed=0, device=cuda)
    config = dict(max_new_tokens=8, max_prompt_len=64, num_slots=4,
                  page_size=16, slice_tokens=4, prefix_cache=True,
                  **sampling)
    config.update(kw)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 512, 40).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 512, n).astype(
        np.int32)]) for n in (5, 12, 3, 20)]
    keys = [prng.PRNGKey(500 + i) for i in range(len(prompts))]
    return model, params, config, prompts, keys


def _b1_unpadded(model, params, prompt, key, budget, sampling, cuda):
    want, _ = generate(model, params, torch.from_numpy(prompt[None]).to(
        cuda), max_new_tokens=budget, rng=key[None],
        prompt_lengths=torch.tensor([len(prompt)], device=cuda), **sampling)
    return want[0].cpu().numpy()


@pytest.mark.parametrize("mode", sorted(ENGINE_SAMPLING))
def test_prefix_handoff_adopts_and_registers_on_the_card(cuda, mode):
    """A prefill-role engine (chunks of 16) hits its own index; each
    right-layout handoff adopted on a decode-role engine equals B=1, and
    the decode engine indexes the carried pages."""
    sampling = ENGINE_SAMPLING[mode]
    model, params, config, prompts, keys = _prefix_case(cuda, sampling)
    prefill = DecodeEngine(model, params, EngineConfig(
        **config, prefill_chunk=16), device=cuda)
    decode = DecodeEngine(model, params, EngineConfig(**config),
                          device=cuda)
    try:
        for p, k in zip(prompts, keys):
            handoff = _blob_round_trip(prefill.run_prefill(p, rng=k))
            assert handoff.layout == "right"
            np.testing.assert_array_equal(
                decode.submit(handoff=handoff).result(timeout=300),
                _b1_unpadded(model, params, p, k, 8, sampling, cuda))
        assert prefill.stats()["prefix_cache"]["hits"] > 0
        assert decode.probe_prefix(prompts[0]) >= 32
        decode.clear_prefix_cache()
        assert decode.stats()["free_pages"] == decode.stats()["total_pages"]
    finally:
        prefill.stop()
        decode.stop()


@pytest.mark.parametrize("mode", sorted(ENGINE_SAMPLING))
def test_host_tier_readopted_hits_equal_cold_on_the_card(cuda, mode):
    """A pool of 8 pages cannot keep a 40-token prefix between requests
    of other prefixes: its blocks spill to host RAM and come back on a
    revisit, which equals its cold run and B=1."""
    sampling = ENGINE_SAMPLING[mode]
    model, params, config, prompts, keys = _prefix_case(
        cuda, sampling, num_slots=1, num_pages=9, host_cache_bytes=1 << 26)
    engine = DecodeEngine(model, params, EngineConfig(**config),
                          device=cuda)
    rng = np.random.default_rng(4)
    others = [rng.integers(0, 512, 60).astype(np.int32) for _ in range(2)]
    try:
        engine.submit(prompts[0], rng=keys[0]).result(timeout=300)
        for i, o in enumerate(others):
            engine.submit(o, rng=prng.PRNGKey(900 + i)).result(timeout=300)
        host = engine.stats()["kv_tier"]["host"]
        assert host["spilled_blocks"] > 0, host
        hit = engine.submit(prompts[1], rng=keys[1]).result(timeout=300)
        assert engine.stats()["kv_tier"]["host"]["readopted_blocks"] > 0
        engine.clear_prefix_cache()
        engine.host_tier.clear()
        cold = engine.submit(prompts[1], rng=keys[1]).result(timeout=300)
        np.testing.assert_array_equal(hit, cold)
        np.testing.assert_array_equal(
            hit, _b1_unpadded(model, params, prompts[1], keys[1], 8,
                              sampling, cuda))
        engine.clear_prefix_cache()
        engine.host_tier.check_accounting()
        assert engine.stats()["free_pages"] == engine.stats()["total_pages"]
    finally:
        engine.stop()


def test_fleet_blocks_import_hits_and_equal_cold_on_the_card(cuda):
    """Engine A's blocks of a served prefix go through the wire into
    engine B's host tier: byte-equal to A's pages, and B's request hits
    them and equals its cold run."""
    from kubeflow_tpu_torch.serving import wire

    model, params, config, prompts, keys = _prefix_case(
        cuda, {"temperature": 0.0}, host_cache_bytes=1 << 26)
    a = DecodeEngine(model, params, EngineConfig(**config), device=cuda)
    b = DecodeEngine(model, params, EngineConfig(**config), device=cuda)
    try:
        a.submit(prompts[0], rng=keys[0]).result(timeout=300)
        blocks = a.export_prefix_blocks(prompts[0])
        assert len(blocks) == 2
        carried = wire.decode_kv_blocks(
            wire.encode_kv_blocks("m", 1, 16, blocks), model="m",
            version=1, page_size=16)
        for (_, got), (_, want) in zip(carried, blocks):
            assert all(torch.equal(g.view(torch.int16), w.view(torch.int16))
                       for g, w in zip(got, want))
        cold = b.submit(prompts[1], rng=keys[1]).result(timeout=300)
        b.clear_prefix_cache()
        assert b.import_prefix_blocks(carried) == 2
        hit = b.submit(prompts[1], rng=keys[1]).result(timeout=300)
        assert b.stats()["kv_tier"]["host"]["readopted_blocks"] == 2
        np.testing.assert_array_equal(hit, cold)
    finally:
        a.stop()
        b.stop()


# -- captured decode programs and the split resume on the card -------------
#
# A captured engine's streams equal an uncaptured engine's bit for bit in
# the engine, prefix, spec and chunk mixes; a replayed slice calls no
# kernel wrapper; every captured key is one engine_compile key; a capture
# that fails raises. A resume given the prompt's length equals the
# uninterrupted stream.

#: The programs the engine captures, by engine_compile program name.
CAPTURED = ("decode_slice", "spec_draft", "spec_verify", "prefill")
WRAPPERS = (dg.decode_linear, rn.rms_norm, da.decode_attention,
            pg.prefill_linear, fa.flash_attention)


def _mix(cuda, mix, sampling):
    """(model, params, config, requests) of one mix at llama-test size:
    the engine mix (classic lane), the prefix mix, the engine mix with a
    strong draft (k = 4), and the prefix mix chunked at 16 with it."""
    if mix in ("engine", "spec"):
        model, params, engine, requests = _engine_case(cuda, 4, sampling)
        engine.stop()
        config = dataclasses.asdict(engine.config)
        if mix == "spec":
            config["speculate_tokens"] = 4
        return model, params, config, requests
    model, params, config, prompts, keys = _prefix_case(cuda, sampling)
    if mix == "chunk":
        config.update(prefill_chunk=16, speculate_tokens=4)
    return model, params, config, [(p, 8, k) for p, k in zip(prompts, keys)]


def _mix_engine(model, params, config, **kw):
    draft = (dict(draft_model=model, draft_params=params)
             if config.get("speculate_tokens") else {})
    device = next(iter(params.values())).device
    return DecodeEngine(model, params, EngineConfig(**config),
                        device=device, **draft, **kw)


def _run_mix(engine, requests):
    streams = [engine.submit(p, rng=k, max_new_tokens=b)
               for p, b, k in requests]
    return [s.result(timeout=300) for s in streams]


@pytest.mark.parametrize("mode", sorted(ENGINE_SAMPLING))
@pytest.mark.parametrize("mix", ["engine", "prefix", "spec", "chunk"])
def test_captured_engine_equals_uncaptured(cuda, mix, mode):
    model, params, config, requests = _mix(cuda, mix,
                                           ENGINE_SAMPLING[mode])
    captured = _mix_engine(model, params, config)
    eager = _mix_engine(model, params, config, capture_graphs=False)
    try:
        want = _run_mix(eager, requests)
        # The first pass captures each key (its first use returns the
        # warm-up's outputs); the second replays every key.
        for _ in range(2):
            got = _run_mix(captured, requests)
            for i, (g, w) in enumerate(zip(got, want)):
                np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
        assert captured.captured_keys()
        assert eager.captured_keys() == set()
        assert captured._graphs.replays() > 0
    finally:
        captured.stop()
        eager.stop()


@pytest.mark.parametrize("mix", ["engine", "spec"])
def test_replayed_slices_call_no_kernel_wrapper(cuda, mix):
    """The mix a second time on the same captured engine: every key is
    captured already, so the classic lane's prefills, slices and rounds
    all replay, and no wrapper counts a launch."""
    model, params, config, requests = _mix(cuda, mix,
                                           ENGINE_SAMPLING["sampled"])
    engine = _mix_engine(model, params, config)
    try:
        first = _run_mix(engine, requests)
        programs = dict(engine._graphs.programs)
        replays = engine._graphs.replays()
        for fn in WRAPPERS:
            fn.launches = 0
        again = _run_mix(engine, requests)
        if mix == "spec":
            # The draft's prefill of each admission stays eager: its
            # projections, its attention on flash and its head's row.
            assert dg.decode_linear.launches == len(requests)
            assert pg.prefill_linear.launches == 7 * model.num_layers * len(
                requests)
            assert fa.flash_attention.launches == model.num_layers * len(
                requests)
            assert da.decode_attention.launches == 0
        else:
            assert [fn.launches for fn in WRAPPERS] == [0] * len(WRAPPERS)
        assert engine._graphs.programs == programs
        assert engine._graphs.replays() > replays
        for a, b in zip(first, again):
            np.testing.assert_array_equal(a, b)
    finally:
        engine.stop()


@pytest.mark.parametrize("mix", ["engine", "prefix", "spec", "chunk"])
def test_one_graph_per_engine_compile_key(cuda, mix):
    model, params, config, requests = _mix(cuda, mix,
                                           ENGINE_SAMPLING["greedy"])
    engine = _mix_engine(model, params, config)
    try:
        _run_mix(engine, requests)
        keys = set(engine._graphs.programs)
        assert keys == {k for k in engine._compile_seen
                        if k[0] in CAPTURED}
        assert engine.captured_keys() == keys
        if config["prefix_cache"]:
            assert not any(k[0] == "prefill" for k in keys)
    finally:
        engine.stop()


def test_a_capture_that_fails_raises(cuda, monkeypatch):
    """A host read inside the captured body breaks the capture: the
    request fails with the error, no graph is kept, and nothing runs
    the body eagerly in its place (the stream gets no token)."""
    from kubeflow_tpu_torch.models import llama

    model, params, config, requests = _mix(cuda, "engine",
                                           ENGINE_SAMPLING["greedy"])
    real = llama.decode_linear

    def syncing(x, w):
        float(x.float().sum())  # a device value read on the host
        return real(x, w)

    monkeypatch.setattr(llama, "decode_linear", syncing)
    engine = _mix_engine(model, params, config)
    try:
        prompt, budget, key = requests[0]
        stream = engine.submit(prompt, rng=key, max_new_tokens=budget)
        with pytest.raises(RuntimeError):
            stream.result(timeout=300)
        assert stream.tokens_so_far == []
        assert not engine._graphs.programs
    finally:
        engine.stop()


@pytest.mark.parametrize("mode", sorted(ENGINE_SAMPLING))
@pytest.mark.parametrize("lane", ["classic", "prefix"])
def test_split_resume_equals_uninterrupted_on_the_card(cuda, lane, mode):
    """Killed after 1 token, the middle and budget - 1: the prompt
    prefilled as at its admission and the emitted tokens replayed on the
    decode route give the rest of the stream bit for bit."""
    sampling = ENGINE_SAMPLING[mode]
    model, params, config, requests = _mix(
        cuda, "engine" if lane == "classic" else "prefix", sampling)
    a = _mix_engine(model, params, config)
    b = _mix_engine(model, params, config)
    try:
        for prompt, budget, key in requests[:3]:
            stream = a.submit(prompt, rng=key, max_new_tokens=budget)
            full = stream.result(timeout=300)
            keys = stream.resume_ctx["step_keys"]
            for kill in (1, budget // 2, budget - 1):
                resumed = b.submit(
                    np.concatenate([prompt, full[:kill]]),
                    step_keys=keys[kill:], prompt_len=len(prompt))
                np.testing.assert_array_equal(resumed.result(timeout=300),
                                              full[kill:])
        assert b.stats()["reserved_pages"] == 0
    finally:
        a.stop()
        b.stop()


def test_captured_prefill_handoff_keeps_its_prompt_width(cuda):
    """The classic prefill's cache index is host state, which a replay
    does not set: after two prompt buckets are captured, a replay of the
    first still hands off a cache whose index is its prompt width, and
    the same K/V as that bucket's first run."""
    model, params, engine, requests = _engine_case(
        cuda, 4, ENGINE_SAMPLING["greedy"])
    try:
        short, long_ = requests[0], requests[1]
        assert engine._prompt_width(len(short[0])) != engine._prompt_width(
            len(long_[0]))
        handoffs = [engine.run_prefill(p, rng=k, max_new_tokens=b)
                    for p, b, k in (short, long_, short)]
        assert len(engine.captured_keys()) == 2
        assert engine._graphs.replays() == 1
        for handoff in handoffs:
            assert [c.index for c in handoff.cache] == [
                handoff.prompt_width] * len(handoff.cache)
        for a, b in zip(handoffs[0].cache, handoffs[2].cache):
            assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
        assert handoffs[0].first_token == handoffs[2].first_token
    finally:
        engine.stop()


def _wrapper_counts():
    return [fn.launches for fn in WRAPPERS]


@pytest.mark.parametrize("mix", ["engine", "spec"])
def test_captured_programs_hold_the_uncaptured_launches(cuda, mix):
    """The same requests, one at a time, on an uncaptured and on a
    captured engine. Each captured key's warm-up and capture call the
    wrappers alike (the capture records what the warm-up ran); the
    captured engine's wrapper launches, less each capture, plus each
    replay's body, are the uncaptured engine's launches."""
    model, params, config, requests = _mix(cuda, mix,
                                           ENGINE_SAMPLING["sampled"])
    launches, tokens = {}, {}
    for captured in (False, True):
        engine = _mix_engine(model, params, config,
                             capture_graphs=captured)
        bodies, calls = {}, []
        if captured:
            run = engine._graphs.run

            def counted(key, body, inputs, run=run, graphs=engine._graphs):
                if key in graphs.programs:
                    calls.append((key, 1))
                    return run(key, body, inputs)
                runs = []

                def recorded(**kw):
                    before = _wrapper_counts()
                    out = body(**kw)
                    runs.append([a - b for a, b in zip(_wrapper_counts(),
                                                       before)])
                    return out

                out = run(key, recorded, inputs)
                assert len(runs) == 2 and runs[0] == runs[1], (key, runs)
                bodies[key] = runs[1]
                calls.append((key, -1))
                return out

            engine._graphs.run = counted
        try:
            for fn in WRAPPERS:
                fn.launches = 0
            tokens[captured] = [
                engine.submit(p, rng=k, max_new_tokens=b).result(300)
                for p, b, k in requests]
            total = _wrapper_counts()
            for key, sign in calls:
                total = [t + sign * n for t, n in zip(total, bodies[key])]
            launches[captured] = total
            if captured:
                assert any(sign == 1 for _, sign in calls)
                del engine._graphs.run
        finally:
            engine.stop()
    assert launches[True] == launches[False]
    assert all(n > 0 for n in launches[True])
    for a, b in zip(tokens[True], tokens[False]):
        np.testing.assert_array_equal(a, b)


def _served_on_the_card(tmp_path, sampling):
    """A ``ServedModel`` over a ``llama-test`` bf16 export, loaded on
    the card the way a server loads it (the version poll, the bucket
    warmup and the engine's warmup, which captures its graphs)."""
    from kubeflow_tpu_torch.models.convert import (
        params_to_flax,
        unflatten_tree,
    )
    from kubeflow_tpu_torch.serving.export import export_model
    from kubeflow_tpu_torch.serving.manager import ServedModel
    from kubeflow_tpu_torch.serving.signature import (
        ModelMetadata,
        Signature,
        TensorSpec,
    )

    kwargs = {"dtype": "bfloat16", "cache_size": 64}
    params = init_params(llama_test(**kwargs), seed=0, device="cpu")
    meta = ModelMetadata(
        model_name="m", registry_name="llama-test", model_kwargs=kwargs,
        signatures={"serving_default": Signature(
            method="generate",
            inputs={"input_ids": TensorSpec("int32", (-1, 16))},
            outputs={"tokens": TensorSpec("int32", (-1, 12))})},
        generate_config={"max_new_tokens": 12, "engine_slots": 2,
                         "engine_page_size": 8, "engine_slice_tokens": 4,
                         "prompt_buckets": [8, 16], "seed": 3,
                         "deterministic": True, **sampling})
    export_model(str(tmp_path / "m"), 1, meta,
                 {"params": unflatten_tree(params_to_flax(params))})
    served = ServedModel("m", str(tmp_path / "m"), max_batch=2,
                         continuous_batching=True)
    assert served.poll_versions()
    return served


@pytest.mark.parametrize("mode", sorted(ENGINE_SAMPLING))
def test_served_model_engine_rows_equal_b1_on_the_card(cuda, tmp_path,
                                                       mode):
    """Unary generates through ``ServedModel.submit`` on the captured
    engine its load built: every row equals B=1 ``generate`` at the
    engine's shapes with the request's key, and the load's warmup left
    nothing to capture for the warm buckets."""
    sampling = ENGINE_SAMPLING[mode]
    served = _served_on_the_card(tmp_path, sampling)
    try:
        loaded = served.get()
        engine = loaded.engine
        warm = engine.captured_keys()
        assert ("prefill", "tokens[1,16]") in warm
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, 512, n).astype(np.int32)
                   for n in (5, 16, 11)]
        futures = [served.submit({"input_ids": p[None]}, None, None, None)
                   for p in prompts]
        key = loaded.request_rngs(1)[0]  # deterministic: every request's
        for p, f in zip(prompts, futures):
            got = f.result(timeout=300)["tokens"][0]
            want = _b1(loaded._module, loaded.params, engine, p, key, 12,
                       sampling, cuda)
            np.testing.assert_array_equal(got, want)
        assert engine.captured_keys() == warm
    finally:
        served.stop()


@pytest.mark.parametrize("mode", sorted(ENGINE_SAMPLING))
def test_served_model_second_death_resumes_bitwise_on_the_card(
        cuda, tmp_path, mode):
    """``submit_resume`` after kills at 1 and the middle, through the
    wire, then a second death one token into the resumed stream: its
    token carries ``prompt_len``, and the second resume, split at the
    original prompt, gives the rest of the uninterrupted stream."""
    from kubeflow_tpu_torch.serving import wire

    served = _served_on_the_card(tmp_path, ENGINE_SAMPLING[mode])

    def token_of(stream):
        ctx = stream.resume_ctx
        return wire.decode_resume_token(wire.encode_resume_token(
            "m", 1, ctx["prompt"], ctx["step_keys"],
            ctx["max_new_tokens"], prompt_len=ctx.get("prompt_len")),
            model="m", version=1)

    try:
        prompt = np.random.default_rng(2).integers(0, 512, 13).astype(
            np.int32)
        _, (first,) = served.submit_stream({"input_ids": prompt[None]},
                                           None, None)
        full = first.result(timeout=300)
        for kill in (1, 6):
            _, (second,) = served.submit_resume(
                [(token_of(first), full[:kill].tolist())], None)
            np.testing.assert_array_equal(second.result(timeout=300),
                                          full[kill:])
            token = token_of(second)
            assert token["prompt_len"] == len(prompt)
            _, (third,) = served.submit_resume(
                [(token, full[kill:kill + 1].tolist())], None)
            np.testing.assert_array_equal(third.result(timeout=300),
                                          full[kill + 1:])
    finally:
        served.stop()


# -- LM training: LoRA and the pretraining step on the card ------------------

def _lora_setup(cuda, remat, seed=0):
    from kubeflow_tpu_torch.ops.lora import init_lora
    from kubeflow_tpu_torch.utils.trees import cast_floating

    model = llama_test(lora_rank=4, remat=remat)
    base = cast_floating(init_params(llama_test(), seed=seed, device=cuda),
                         torch.bfloat16)
    lora = init_lora(model, seed=seed, device=cuda)
    ids = torch.randint(0, 512, (2, 64), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(7),
                        dtype=torch.int32)
    return model, base, lora, {"input_ids": ids}


def test_lora_remat_gradients_equal_no_remat_on_the_card(cuda):
    """The remat recompute runs the same kernels on the same inputs, so
    the adapters' gradients are the same bits with and without it (B
    drawn nonzero, so both factors get one)."""
    from kubeflow_tpu_torch.training.lm import causal_lm_loss

    grads = []
    for remat in (False, True):
        model, base, lora, batch = _lora_setup(cuda, remat)
        gen = torch.Generator(device=cuda).manual_seed(3)
        for k in lora:
            if k.endswith(".lora_b"):
                lora[k] = torch.randn(lora[k].shape, device=cuda,
                                      generator=gen) * 0.02
        lora = {k: v.requires_grad_(True) for k, v in lora.items()}
        logits = apply(model, {**base, **lora}, batch["input_ids"])
        loss, _ = causal_lm_loss(logits, batch)
        grads.append(torch.autograd.grad(loss, list(lora.values())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_lora_step0_equals_base_and_base_stays_frozen_on_the_card(cuda):
    from kubeflow_tpu_torch.training.finetune import (
        create_lora_state,
        make_lora_train_step,
    )
    from kubeflow_tpu_torch.training.lm import (
        causal_lm_loss,
        lm_forward_with_aux,
    )
    from kubeflow_tpu_torch.training.optim import adamw

    model, base, lora, batch = _lora_setup(cuda, remat=True)
    with torch.no_grad():
        _, (base_loss, _, _) = lm_forward_with_aux(
            llama_test(), base, batch, causal_lm_loss, 0.01)
    state, _ = create_lora_state(model, adamw(1e-2), base, lora)
    frozen = {k: v.clone() for k, v in state.base_params.items()}
    step = make_lora_train_step()
    losses = []
    for _ in range(4):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
    assert torch.equal(losses[0], base_loss)  # B is zero at step 0
    assert float(losses[-1]) < float(losses[0])
    for k, v in state.base_params.items():
        assert v.grad is None and not v.requires_grad, k
        assert torch.equal(v, frozen[k]), k


@pytest.mark.parametrize("kind", ["lora_remat", "pretrain"])
def test_train_step_launches_match_the_formula_on_the_card(cuda, kind):
    """Flash once a layer and RMSNorm twice a layer plus once a forward;
    a remat backward runs each block's forward again."""
    from kubeflow_tpu_torch.training.finetune import (
        create_lora_state,
        make_lora_train_step,
    )
    from kubeflow_tpu_torch.training.lm import (
        create_lm_state,
        make_lm_train_step,
    )
    from kubeflow_tpu_torch.training.optim import adamw

    layers = 2
    if kind == "lora_remat":
        model, base, lora, batch = _lora_setup(cuda, remat=True)
        state, _ = create_lora_state(model, adamw(1e-3), base, lora)
        step = make_lora_train_step()
        want = {"flash": 2 * layers, "rms": 2 * (2 * layers) + 1}
    else:
        model = llama_test(param_dtype="float32")
        state, _ = create_lm_state(model, adamw(1e-3), init_params(
            model, seed=0, device=cuda))
        batch = _lora_setup(cuda, remat=False)[3]
        step = make_lm_train_step()
        want = {"flash": layers, "rms": 2 * layers + 1}
    step(state, batch)  # the first call builds nothing more, but warms up
    fa.flash_attention.launches = rn.rms_norm.launches = 0
    step(state, batch)
    torch.cuda.synchronize()
    assert {"flash": fa.flash_attention.launches,
            "rms": rn.rms_norm.launches} == want


def _token_shard(directory, seq_len, vocab=512, seed=3):
    """One random sequence of ``seq_len`` ids repeated: every chunk the
    stream cuts is that sequence, so each step sees the same batch."""
    ids = np.random.RandomState(seed).randint(0, vocab, seq_len)
    path = str(directory / "tokens.npy")
    np.save(path, np.tile(ids.astype(np.int32), 8))
    return path


def _last_json_line(capsys):
    import json

    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_lora_benchmark_cli_on_token_shards_on_the_card(cuda, tmp_path,
                                                        capsys):
    """``training.benchmark --lora_rank`` as a user runs it on the card:
    the base drawn in fp32 and cast to bf16, the shard's batches put on
    the card by the prefetch thread, the step's launches by the
    formula."""
    from kubeflow_tpu_torch.training import benchmark

    shard = _token_shard(tmp_path, 32)
    fa.flash_attention.launches = rn.rms_norm.launches = 0
    assert benchmark.main(["--model", "llama-test", "--lora_rank", "4",
                           "--seq_len", "32", "--batch_size", "2",
                           "--steps", "2", "--data", shard]) == 0
    torch.cuda.synchronize()
    result = _last_json_line(capsys)
    model = llama_test(lora_rank=4)
    assert result["trainable_params"] == sum(
        p.numel() for n, p in model.named_parameters() if "lora_" in n)
    assert result["device"] == torch.cuda.get_device_name(cuda)
    losses = result["warmup_losses"] + result["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    # 3 steps, each flash twice a layer and RMSNorm 4 a layer + 1
    # (forward and remat recompute), over 2 layers.
    assert (fa.flash_attention.launches, rn.rms_norm.launches) == (
        3 * 4, 3 * 9)


def test_pretrain_cli_resumes_from_its_checkpoints_on_the_card(
        cuda, tmp_path, capsys):
    """``training.pretrain`` on the card with both checkpoint tiers: a
    run of 6 steps; then its steps after 4 deleted, as a crash after
    step 4's saves leaves it, and the same command again restores step
    4 onto the card and takes steps 5 and 6 to the same losses, bit for
    bit."""
    import json
    import shutil

    shard = _token_shard(tmp_path, 32)
    ckpt = tmp_path / "ckpt"

    def run(metrics):
        assert pretrain.main([
            "--model", "llama-test", "--global_batch", "2",
            "--seq_len", "32", "--steps", "6", "--warmup_steps", "2",
            "--learning_rate", "1e-2", "--log_every", "1",
            "--data", shard, "--checkpoint_dir", str(ckpt),
            "--save_every", "2", "--continuous_every", "1",
            "--metrics_path", str(metrics)]) == 0
        assert _last_json_line(capsys)["final_step"] == 6
        with open(metrics) as f:
            return {r["step"]: r["loss"] for r in map(json.loads, f)}

    from kubeflow_tpu_torch.training import pretrain

    first = run(tmp_path / "first.jsonl")
    assert sorted(first) == [1, 2, 3, 4, 5, 6]
    assert first[2] == first[1]  # the first update's rate is 0
    assert first[6] < first[1]
    # The continuous tier's writer may have dropped a step it was
    # behind on; the periodic tier holds step 4 whatever it dropped.
    for tier in (ckpt, ckpt / "continuous"):
        for step_dir in tier.glob("step-*"):
            if int(step_dir.name[len("step-"):]) > 4:
                shutil.rmtree(step_dir)
    assert (ckpt / "step-00000004" / "manifest.json").is_file()
    resumed = run(tmp_path / "resumed.jsonl")
    assert resumed == {5: first[5], 6: first[6]}


# -- the rest of the registry: ViT's and BERT's flash shapes, Inception's
# BN shapes, a served ViT -----------------------------------------------------

@pytest.mark.parametrize("name,b,l,masked", [
    ("vit-b16", 4, 196, False),   # a 128-row q tile and a 68-row tail
    ("bert-base", 4, 128, True),  # one q tile, padded keys
])
def test_flash_at_vit_and_bert_shapes_rows_are_width_free(cuda, name, b, l,
                                                          masked):
    """The kernel against its plain version at the model's [B, L, 12,
    64], and each block of the first w query rows (w = 1 … 129) equal
    to the same rows of the whole block, bit for bit: a row's bits do not
    depend on how many rows share its launch."""
    q, k, v = _qkv(cuda, b, l, l, 12, 12, 64, torch.bfloat16)
    mask = None
    if masked:
        lengths = torch.tensor([l, l * 3 // 4, l // 2, 1], device=cuda)[:b]
        mask = (torch.arange(l, device=cuda)[None] < lengths[:, None]).to(
            torch.int32)
    out = fa.flash_attention(q, k, v, kv_segment_valid=mask)
    ref = fa.flash_attention_reference(q, k, v, kv_segment_valid=mask)
    torch.cuda.synchronize()
    assert float((out.float() - ref.float()).abs().max()) <= TOL[
        torch.bfloat16]
    for w in range(1, 130):
        part = fa.flash_attention(q[:, :w].contiguous(), k, v,
                                  kv_segment_valid=mask)
        assert torch.equal(part, out[:, :w]), w


def _inception_bn_shapes(batch):
    """Each distinct [M, C] Inception-v3's BN layers hand the kernel in a
    training forward at ``batch``, 299², from a meta-device forward."""
    from kubeflow_tpu_torch.models.registry import get_model

    seen = {}

    def record(x, scale, bias, eps=1e-5, stat_rows=None):
        assert eps == 1e-3
        seen[tuple(x.shape)] = seen.get(tuple(x.shape), 0) + 1
        return (torch.empty_like(x), x.new_empty(x.shape[1]),
                x.new_empty(x.shape[1]))

    model = get_model("inception-v3").make(norm_fn=record)
    for mod in model.modules():
        if isinstance(mod, GhostBatchNorm):
            mod.register_forward_pre_hook(lambda _, args: (
                args[0].contiguous(memory_format=torch.channels_last),
                *args[1:]))
    with torch.no_grad():
        model(torch.empty(batch, 299, 299, 3, device="meta"), train=True)
    return seen


def test_bn_kernel_at_every_inception_shape(cuda):
    """The BN kernel against its plain version at each distinct BN shape
    of Inception-v3 at b16 (ε = 1e-3; channel widths 32 … 448, many not
    multiples of 128, and ragged row counts), bf16, and one fp32 shape."""
    shapes = _inception_bn_shapes(16)
    assert sum(shapes.values()) == 94
    cases = [(m, c, torch.bfloat16) for m, c in shapes]
    cases.append((16 * 35 * 35, 288, torch.float32))
    for m, c, dtype in cases:
        x, scale, bias = _bn_inputs(cuda, m, c, dtype)
        y, mean, var = bn_fused.fused_bn_train_forward(x, scale, bias,
                                                       eps=1e-3)
        y_ref, mean_ref, var_ref = bn_fused.reference_bn_train_forward(
            x, scale, bias, eps=1e-3)
        torch.testing.assert_close(mean, mean_ref, atol=1e-4, rtol=1e-5)
        torch.testing.assert_close(var, var_ref, atol=1e-4, rtol=1e-5)
        diff = float((y.float() - y_ref.float()).abs().max())
        assert diff <= BN_Y_TOL[dtype] * max(
            1.0, float(y_ref.float().abs().max())), (m, c, dtype)


def test_served_vit_equals_its_module(cuda, tmp_path):
    """A port export of vit-test (bf16) through ``load_version`` serves
    ``predict`` equal to the module applied to the same images, bit for
    bit, through the flash kernel."""
    from kubeflow_tpu_torch.models.convert import (
        init_vision,
        params_to_flax,
        unflatten_tree,
    )
    from kubeflow_tpu_torch.models.layers import apply as apply_vision
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.serving.export import export_model
    from kubeflow_tpu_torch.serving.model import load_version
    from kubeflow_tpu_torch.serving.signature import (
        ModelMetadata,
        Signature,
        TensorSpec,
    )

    model = get_model("vit-test").make()
    params, _ = init_vision(model, seed=0, device=cuda)
    meta = ModelMetadata(
        model_name="vit", registry_name="vit-test", model_kwargs={},
        signatures={"serving_default": Signature(
            method="predict",
            inputs={"images": TensorSpec("float32", (-1, 32, 32, 3))},
            outputs={"logits": TensorSpec("float32", (-1, 10))})})
    export_model(str(tmp_path), 1, meta,
                 {"params": unflatten_tree(params_to_flax(params))})
    served = load_version(str(tmp_path / "1"), max_batch=4)
    x = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    before = fa.flash_attention.launches
    got = served.run({"images": x})["logits"]
    assert fa.flash_attention.launches == before + 2  # one a layer
    with torch.inference_mode():
        want = apply_vision(model, params, None,
                            torch.from_numpy(x).to(cuda), train=False)
    assert np.array_equal(got, want.cpu().numpy())


def test_vit_benchmark_counts_the_same_flops_on_the_card_and_the_cpu(cuda):
    """``run_benchmark``'s FLOP counter sees ViT's attention as a forward
    and its backward on either device (the CPU's plain version; the
    card's plain recompute in the backward, the kernel forward hidden
    from it), so a vit-test step counts the same FLOPs on both."""
    from kubeflow_tpu_torch.training import benchmark

    config = benchmark.BenchConfig(model="vit-test", batch_size=4, steps=1,
                                   warmup_steps=1, image_size=32)
    on_card = benchmark.run_benchmark(config, device=cuda)
    on_cpu = benchmark.run_benchmark(config, device="cpu")
    assert on_card["flops_per_step"] == on_cpu["flops_per_step"] > 0
