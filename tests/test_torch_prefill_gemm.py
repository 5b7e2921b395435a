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

"""The prefill GEMM through its plain twin on the CPU, and the model's
routes to it.

The twin (``F.linear``) holds against the reference's ``nn.Dense`` (the
``_dense`` of kubeflow_tpu/models/llama.py) at the reference's fp32
tolerance; a llama-test cache forward with more than one token a row
sends its seven bf16 projections a layer through ``prefill_linear``, a
decode step and the cache-free forward none; a prefix hit's one-token
tail is prefilled in a 2-wide block, so it takes the prefill's route as
its cold run does. The kernel itself runs in tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.llama import _dense
from kubeflow_tpu_torch.inference import prng
from kubeflow_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from kubeflow_tpu_torch.inference.generate import generate, init_cache
from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.models.convert import init_params
from kubeflow_tpu_torch.ops import prefill_gemm as pg


@pytest.mark.parametrize("m,k,n", [(1, 64, 128), (7, 64, 96), (33, 72, 40),
                                   (128, 256, 512), (257, 128, 33)])
def test_prefill_linear_twin_matches_the_reference_dense(m, k, n):
    rng = np.random.default_rng(m * 1000 + k + n)
    x = rng.standard_normal((2, m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
    want = _dense(n, ("embed", "mlp"), jnp.float32).apply(
        {"params": {"kernel": jnp.asarray(w.T)}}, jnp.asarray(x))
    before = pg.prefill_linear.launches
    got = pg.prefill_linear(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (2, m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert pg.prefill_linear.launches == before


@pytest.mark.parametrize("bad", ["k_mismatch", "float32", "dtype_mix",
                                 "k_not_8", "w_strided"])
def test_prefill_linear_checks_what_the_kernel_takes(bad):
    bf = torch.bfloat16
    x, w = torch.ones(4, 64, dtype=bf), torch.ones(8, 64, dtype=bf)
    match = None
    if bad == "k_mismatch":
        w, match = torch.ones(8, 32, dtype=bf), "x · Wᵀ"
    elif bad == "float32":
        x, w, match = x.float(), w.float(), "bfloat16"
    elif bad == "dtype_mix":
        w, match = w.float(), "bfloat16"
    elif bad == "k_not_8":
        x, w, match = x[:, :60], w[:, :60].contiguous(), "multiple of 8"
    else:
        w, match = torch.ones(64, 8, dtype=bf).t(), "contiguous"
    with pytest.raises(ValueError, match=match):
        pg._check_inputs(x, w)


def test_prefill_linear_refuses_a_device_other_than_cpu_or_cuda():
    x = torch.ones(2, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pg.prefill_linear(x, x[:1].expand(8, 64))


class _Calls(dict):
    """Call counts by route; ``offsets`` holds each prefill_attention
    call's (q_offset, block width)."""

    def __init__(self, names):
        super().__init__((name, 0) for name in names)
        self.offsets = []


@pytest.fixture
def calls(monkeypatch):
    """Calls of the model's linear and attention routes over the cache,
    counted at the model's own names (the plain twins run underneath)."""
    counts = _Calls(("prefill_linear", "decode_linear", "prefill_attention",
                     "decode_attention"))

    def counting(name, fn):
        def wrapped(*a, **kw):
            counts[name] += 1
            if name == "prefill_attention":
                counts.offsets.append((a[3], a[0].shape[1]))
            return fn(*a, **kw)
        return wrapped

    for name in list(counts):
        monkeypatch.setattr(llama, name, counting(name, getattr(llama, name)))
    return counts


def test_cache_forward_routes_bf16_projections_to_the_prefill_gemm(calls):
    """llama-test bf16: a cache forward with L > 1 sends exactly 7 ×
    num_layers products through prefill_linear (the fp32 head, at the
    one position a row generate reads, goes through decode_linear) and
    its attention once a layer, the whole block at offset 0, through
    prefill_attention (the flash kernel on the card), never through
    decode_attention; a decode step none of the prefill's, and the
    cache-free forward none of either."""
    model = llama.llama_test(cache_size=32)
    params = init_params(model, seed=0, device="cpu")
    layers = model.num_layers
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (2, 8)).astype(np.int32))
    with torch.inference_mode():
        generate(model, params, ids, max_new_tokens=1)
    assert calls == {"prefill_linear": 7 * layers, "decode_linear": 1,
                     "prefill_attention": layers, "decode_attention": 0}
    assert calls.offsets == [(0, 8)] * layers
    with torch.inference_mode():
        generate(model, params, ids, max_new_tokens=4)
    after = {"prefill_linear": 2 * 7 * layers,
             "decode_linear": 2 + 3 * (7 * layers + 1),
             "prefill_attention": 2 * layers,
             "decode_attention": 3 * layers}
    assert calls == after
    free = llama.llama_test()
    with torch.inference_mode():
        llama.apply(free, params, ids)
    assert calls == after


def test_cache_forward_head_is_the_decode_route_with_or_without_logits_at(
        calls):
    """A cache prefill's fp32 head runs on decode_linear whether or not
    the caller picks a position: no cuBLAS head remains on a cache
    forward, so the full-width logits' rows equal ``logits_at``'s."""
    model = llama.llama_test(cache_size=32)
    params = init_params(model, seed=0, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, 512, (2, 8)).astype(np.int32))
    out = []
    for kw in ({}, {"logits_at": torch.tensor([7, 3])}):
        with torch.inference_mode():
            out.append(llama.apply(model, params, ids,
                                   cache=init_cache(model, params, 2), **kw))
    assert calls == {"prefill_linear": 2 * 7 * model.num_layers,
                     "decode_linear": 2,
                     "prefill_attention": 2 * model.num_layers,
                     "decode_attention": 0}
    assert out[0].shape == (2, 8, 512) and out[1].shape == (2, 1, 512)
    assert torch.equal(out[0][0, 7], out[1][0, 0])
    assert torch.equal(out[0][1, 3], out[1][1, 0])


def test_fp32_prefill_keeps_its_linear_layers(calls):
    """The kernel takes bf16: an fp32 model's prefill projections stay
    ``layer(x)`` (its head, at the position read, takes decode_linear
    as every model's does); its attention takes prefill_attention as a
    bf16 model's does (the flash kernel's fp32 route on the card)."""
    model = llama.llama_test(dtype="float32", cache_size=32)
    params = init_params(model, seed=0, device="cpu")
    ids = torch.zeros((1, 8), dtype=torch.int32)
    generate(model, params, ids, max_new_tokens=1)
    assert calls == {"prefill_linear": 0, "decode_linear": 1,
                     "prefill_attention": model.num_layers,
                     "decode_attention": 0}


def test_one_token_hit_tail_is_prefilled_on_the_prefill_route(calls):
    """A prompt cached whole leaves a one-token tail: the engine
    prefills it in a 2-wide block, so it runs the prefill's kernels as
    the cold run's block does (a one-token cache forward is a decode
    step); a cold one-token prompt keeps its width, as B=1 generate
    runs it."""
    model = llama.llama_test(cache_size=64)
    params = init_params(model, seed=0, device="cpu")
    engine = DecodeEngine(model, params, EngineConfig(
        max_new_tokens=4, max_prompt_len=48, num_slots=1, page_size=8,
        slice_tokens=2, prefix_cache=True), device="cpu")
    try:
        assert engine._tail_width(36, 35) == 2
        assert engine._tail_width(1, 0) == 1
        assert engine._tail_width(45, 32) == 16
        prompt = np.random.default_rng(3).integers(0, 512, 20).astype(
            np.int32)
        first = engine.submit(prompt, rng=prng.PRNGKey(0)).result(120)
        again = engine.submit(prompt, rng=prng.PRNGKey(0)).result(120)
        np.testing.assert_array_equal(first, again)
        px = engine.stats()["prefix_cache"]
        assert px["hits"] == 1 and px["saved_prefill_tokens"] == 19, px
        layers = model.num_layers
        # Two admissions, each one prefill forward (its head on the row
        # read through decode_linear, its attention one prefill_attention
        # call a layer); 3 decode steps each.
        assert calls == {"prefill_linear": 2 * 7 * layers,
                         "decode_linear": 2 * (1 + 3 * (7 * layers + 1)),
                         "prefill_attention": 2 * layers,
                         "decode_attention": 2 * 3 * layers}
        # The cold block (the prompt's 32-wide bucket) from slot 0; the
        # hit's one-token tail, 2 wide, at the cache's index: 19.
        assert calls.offsets == [(0, 32)] * layers + [(19, 2)] * layers
    finally:
        engine.stop()


def test_one_token_chunks_are_prefilled_on_the_prefill_route(calls):
    """Chunked prefill one token a chunk (pages of 1): each chunk runs
    in a 2-wide block on the prefill's kernels, as the one-shot block
    does, never as a one-token decode step; the stream equals the
    one-shot engine's."""
    model = llama.llama_test(cache_size=32)
    params = init_params(model, seed=0, device="cpu")
    prompt = np.random.default_rng(4).integers(0, 512, 5).astype(np.int32)
    out = []
    for chunk in (1, 0):
        engine = DecodeEngine(model, params, EngineConfig(
            max_new_tokens=4, max_prompt_len=16, num_slots=1, page_size=1,
            slice_tokens=2, prefix_cache=True, prefill_chunk=chunk),
            device="cpu")
        try:
            calls.update(prefill_linear=0, decode_linear=0,
                         prefill_attention=0, decode_attention=0)
            calls.offsets.clear()
            out.append(engine.submit(prompt, rng=prng.PRNGKey(0)).result(
                120))
            layers = model.num_layers
            # Five chunks (or one block), each with its head on the row
            # read and its attention one prefill_attention call a layer
            # at the cache's index, then 3 decode steps.
            forwards = 5 if chunk else 1
            assert calls == {
                "prefill_linear": forwards * 7 * layers,
                "decode_linear": forwards + 3 * (7 * layers + 1),
                "prefill_attention": forwards * layers,
                "decode_attention": 3 * layers}
            # Chunk i of one token, 2 wide, at the cache's index i; the
            # one-shot block (8 wide, its bucket) at 0.
            blocks = [(i, 2) for i in range(5)] if chunk else [(0, 8)]
            assert calls.offsets == [b for b in blocks for _ in range(layers)]
        finally:
            engine.stop()
    np.testing.assert_array_equal(out[0], out[1])


# -- the launch plan ---------------------------------------------------------
#
# The kernel's plan (tile, K split, ring, shared memory, grid) mirrored in
# Python (tests/test_torch_gpu.py holds the mirror against the built
# kernel's query). A row's reduction order follows the tile and the split,
# so only the grid may follow M.

#: llama3-8b's prefill products: (K, N).
LLAMA_PREFILL = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
H100_SMEM = 232448


@pytest.mark.parametrize("k,n", LLAMA_PREFILL + ((72, 40), (1024, 33)))
def test_prefill_plan_depends_on_m_only_through_the_grid(k, n):
    fixed = pg.launch_plan(1, n, k)._replace(**dict.fromkeys(pg.M_FIELDS, 0))
    for m in range(1, 1025):
        plan = pg.launch_plan(m, n, k)
        assert plan._replace(**dict.fromkeys(pg.M_FIELDS, 0)) == fixed, m
        assert plan.tiles_m == -(-m // pg.TILE_M)


@pytest.mark.parametrize("k,n", LLAMA_PREFILL + ((72, 40), (1024, 33)))
def test_prefill_plan_fits_a_ctas_shared_memory(k, n):
    plan = pg.launch_plan(512, n, k)
    assert plan.smem_bytes <= H100_SMEM
    assert plan.smem_bytes >= plan.stages * pg.stage_bytes(plan.tile_n)
    assert plan.ctas % (plan.split * plan.share) == 0
    assert plan.ctas <= pg.H100_SMS
    assert 1 in (plan.split, plan.share)


#: Clusters an H100 SXM holds at once at the k/v plan's shape (3 CTAs of
#: 199,744 bytes of shared memory), as the kernel's occupancy query reads
#: it on the card; the 32 output tiles of k/v at M = 512 run in one round.
H100_CLUSTERS_OF_3 = 39


def test_prefill_plan_fills_the_card_at_k_v():
    """k/v [4096 → 1024] at M = 512: 32 output tiles, each split over K
    three ways, so 96 CTAs of work, all at once, where one tile a CTA
    gave 32."""
    plan = pg.launch_plan(512, 1024, 4096, H100_CLUSTERS_OF_3)
    tiles = plan.tiles_m * -(-1024 // plan.tile_n)
    assert plan.split == 3 and tiles <= H100_CLUSTERS_OF_3
    assert plan.ctas == tiles * plan.split == 96
    # The wide shapes need no split (a tile's K in one CTA); pairs of
    # their column blocks share x's tile.
    for k, n in LLAMA_PREFILL:
        if n >= 4096:
            plan = pg.launch_plan(512, n, k)
            assert (plan.split, plan.share) == (1, 2)
