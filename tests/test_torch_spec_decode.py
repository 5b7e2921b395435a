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

"""The port's speculative decoding and chunked prefill.

Port twins of tests/test_spec_decode.py — the same prompts, seeds,
configs and drafts, on ``llama-test`` fp32 with the reference's params
carried across: a spec engine's streams (strong draft, garbage draft)
and a chunked engine's streams equal the vanilla / one-shot engine's
and the same request run alone through the port's ``generate`` at B=1,
greedy and sampled, and equal the reference engine's tokens on the same
requests and keys. Then the model's verify forward (``decode_positions``
with l = k + 1) against the reference's, a draft export written by the
reference served through the port's ``ensure_engine``, and the
multi-token append / rollback page accounting fuzz.
"""

import dataclasses
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from kubeflow_tpu.inference.engine import DecodeEngine as JaxDecodeEngine
from kubeflow_tpu.inference.engine import EngineConfig as JaxEngineConfig
from kubeflow_tpu.inference.generate import init_cache as jax_init_cache
from kubeflow_tpu.models.llama import Llama as JaxLlama
from kubeflow_tpu.models.llama import llama_test as jax_llama_test
from kubeflow_tpu.serving.export import export_model as jax_export_model
from kubeflow_tpu.serving.signature import ModelMetadata as JaxMetadata
from kubeflow_tpu_torch.inference import prng
from kubeflow_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from kubeflow_tpu_torch.inference.engine.paged_kv import PagedKVCache
from kubeflow_tpu_torch.inference.engine.prefix_cache import PrefixCache
from kubeflow_tpu_torch.inference.generate import (
    generate,
    init_cache,
    prompt_bucket,
)
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.llama import (
    LayerCache,
    Llama,
    apply,
    llama_test,
)
from kubeflow_tpu_torch.obs import metrics as obs_metrics
from kubeflow_tpu_torch.obs import tracing
from kubeflow_tpu_torch.serving.model import LoadedModel
from kubeflow_tpu_torch.serving.signature import (
    ModelMetadata,
    Signature,
    TensorSpec,
)

CACHE = 64
MAX_PROMPT = 24
NEW_TOKENS = 12
K = 3
SAMPLED = dict(temperature=0.8, top_k=50)
WEAK = dict(num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
            mlp_dim=64)


def _to_port(flax_params, model):
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(flax_params, sep="/").items()}
    return convert.params_from_flax(flat, model, device="cpu")


@pytest.fixture(scope="module")
def jax_model():
    return jax_llama_test(dtype=jnp.float32, cache_size=CACHE)


@pytest.fixture(scope="module")
def jax_params(jax_model):
    return nn.meta.unbox(jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])


@pytest.fixture(scope="module")
def model():
    return llama_test(dtype="float32", cache_size=CACHE)


@pytest.fixture(scope="module")
def params(model, jax_params):
    return _to_port(jax_params, model)


@pytest.fixture(scope="module")
def jax_weak_draft(jax_model):
    """The reference's own weak draft (tests/test_spec_decode.py): a
    random tiny model sharing the verifier's vocab and cache geometry
    but nothing else, so its proposals are noise."""
    draft = JaxLlama(vocab_size=jax_model.vocab_size, cache_size=CACHE,
                     dtype=jnp.float32, **WEAK)
    dparams = nn.meta.unbox(draft.init(
        jax.random.PRNGKey(9), jnp.zeros((1, 8), jnp.int32))["params"])
    return draft, dparams


@pytest.fixture(scope="module")
def weak_draft(model, jax_weak_draft):
    draft = Llama(vocab_size=model.vocab_size, cache_size=CACHE,
                  dtype="float32", **WEAK)
    return draft, _to_port(jax_weak_draft[1], draft)


def _prompts(*lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 512, (n,)).astype(np.int32) for n in lengths]


def _keys(n, base=700):
    return [prng.PRNGKey(base + i) for i in range(n)]


def _reference(model, params, prompt, key, max_new_tokens, *,
               left_pad=True, **sampling):
    """B=1 ``generate`` at the engine's shapes: the prompt left-padded
    to its bucket (the plain lane), or unpadded (the pad-0 prefix
    layout)."""
    width = prompt_bucket(len(prompt), MAX_PROMPT) if left_pad \
        else len(prompt)
    ids = np.zeros((1, width), np.int32)
    ids[0, width - len(prompt):] = prompt
    tokens, _ = generate(
        model, params, torch.from_numpy(ids), max_new_tokens=max_new_tokens,
        rng=key[None], prompt_lengths=torch.tensor([len(prompt)]),
        **sampling)
    return tokens[0].numpy()


def _config(*, k=0, max_prompt=MAX_PROMPT, new_tokens=NEW_TOKENS, slots=3,
            page_size=4, slice_tokens=4, **config):
    return dict(max_new_tokens=new_tokens, max_prompt_len=max_prompt,
                num_slots=slots, page_size=page_size,
                slice_tokens=slice_tokens, speculate_tokens=k, **config)


def _engine(model, params, *, draft=None, name="spec-test", **config):
    draft_model, draft_params = draft if draft else (None, None)
    return DecodeEngine(model, params, EngineConfig(**_config(**config)),
                        name=name, device="cpu", draft_model=draft_model,
                        draft_params=draft_params)


def _jax_tokens(jax_model, jax_params, requests, *, draft=None, **config):
    """The reference engine's tokens for ``requests`` ((prompt, key)
    pairs), all submitted at once."""
    draft_model, draft_params = draft if draft else (None, None)
    engine = JaxDecodeEngine(
        jax_model, jax_params, JaxEngineConfig(**_config(**config)),
        name="spec-jax", draft_model=draft_model, draft_params=draft_params)
    try:
        streams = [engine.submit(p, rng=k) for p, k in requests]
        return [s.result(timeout=180) for s in streams]
    finally:
        engine.stop()


def _assert_pool_clean(engine):
    st = engine.stats()
    assert st["active_slots"] == 0, st
    assert st["free_pages"] + st.get(
        "prefix_cache", {}).get("cached_pages", 0) \
        == st["total_pages"], f"leaked pages: {st}"
    assert st["reserved_pages"] == 0, st
    engine.kv.allocator.check_invariants()


# -- speculative decoding: exactness + acceptance economics ---------------


def test_strong_draft_bitwise_greedy_with_high_acceptance(
        model, params, jax_model, jax_params):
    """Draft == verifier: the acceptance ceiling. Streams equal B=1 and
    the reference spec engine's, acceptance is high, and each slot needs
    fewer verifier forwards than tokens it emits."""
    engine = _engine(model, params, draft=(model, params), k=K,
                     name="spec-strong")
    prompts = _prompts(5, 17, 9, seed=1)
    keys = _keys(3)
    emitted = 0
    try:
        streams = [engine.submit(p, rng=k) for p, k in zip(prompts, keys)]
        got = [s.result(timeout=120) for s in streams]
        for p, key, g in zip(prompts, keys, got):
            emitted += len(g)
            np.testing.assert_array_equal(
                g, _reference(model, params, p, key, NEW_TOKENS))
        spec = engine.stats()["spec"]
        assert spec["k"] == K
        assert spec["acceptance_rate"] > 0.5, spec
        assert spec["drafted_tokens"] // K < emitted, spec
        _assert_pool_clean(engine)
    finally:
        engine.stop()
    ref = _jax_tokens(jax_model, jax_params, list(zip(prompts, keys)),
                      draft=(jax_model, jax_params), k=K)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_strong_draft_bitwise_sampled(model, params, jax_model,
                                      jax_params):
    """Sampled: targets are drawn from VERIFIER logits with the slot's
    own step keys, so the draws are the vanilla schedule's whatever the
    draft proposed."""
    engine = _engine(model, params, draft=(model, params), k=K,
                     name="spec-strong-sampled", **SAMPLED)
    prompts = _prompts(7, 16, seed=2)
    keys = _keys(2, base=720)
    try:
        streams = [engine.submit(p, rng=k) for p, k in zip(prompts, keys)]
        got = [s.result(timeout=120) for s in streams]
        for p, key, g in zip(prompts, keys, got):
            np.testing.assert_array_equal(
                g, _reference(model, params, p, key, NEW_TOKENS, **SAMPLED))
        assert engine.stats()["spec"]["acceptance_rate"] > 0.5
        _assert_pool_clean(engine)
    finally:
        engine.stop()
    ref = _jax_tokens(jax_model, jax_params, list(zip(prompts, keys)),
                      draft=(jax_model, jax_params), k=K, **SAMPLED)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_weak_draft_stays_bitwise_at_near_zero_acceptance(
        model, params, weak_draft, jax_model, jax_params, jax_weak_draft):
    engine = _engine(model, params, draft=weak_draft, k=K,
                     name="spec-weak")
    prompts = _prompts(5, 13, seed=3)
    keys = _keys(2, base=740)
    try:
        streams = [engine.submit(p, rng=k) for p, k in zip(prompts, keys)]
        got = [s.result(timeout=120) for s in streams]
        for p, key, g in zip(prompts, keys, got):
            np.testing.assert_array_equal(
                g, _reference(model, params, p, key, NEW_TOKENS))
        spec = engine.stats()["spec"]
        assert spec["drafted_tokens"] > 0
        assert spec["acceptance_rate"] < 0.5, spec
        _assert_pool_clean(engine)
    finally:
        engine.stop()
    ref = _jax_tokens(jax_model, jax_params, list(zip(prompts, keys)),
                      draft=jax_weak_draft, k=K)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_spec_knob_without_draft_degrades_to_vanilla(model, params):
    """engine_draft_tokens > 0 but no draft weights: decode vanilla
    with a warning, never fail (serving/model.py's degrade path)."""
    engine = _engine(model, params, k=2, name="spec-degraded")
    prompt, key = _prompts(6, seed=4)[0], _keys(1, base=760)[0]
    try:
        assert "spec" not in engine.stats()
        np.testing.assert_array_equal(
            engine.submit(prompt, rng=key).result(timeout=120),
            _reference(model, params, prompt, key, NEW_TOKENS))
    finally:
        engine.stop()


def test_incompatible_draft_rejected(model, params):
    bad_vocab = Llama(vocab_size=model.vocab_size + 1, cache_size=CACHE,
                      dtype="float32", **WEAK)
    with pytest.raises(ValueError, match="vocab_size"):
        _engine(model, params, draft=(bad_vocab, {}), k=2)
    bad_cache = Llama(vocab_size=model.vocab_size, cache_size=CACHE + 4,
                      dtype="float32", **WEAK)
    with pytest.raises(ValueError, match="cache_size"):
        _engine(model, params, draft=(bad_cache, {}), k=2)


def test_spec_metrics_and_spans_emitted(model, params):
    """The spec counter families land in the metrics render, and the
    split draft / verify attribution lands on the engine_slice,
    spec_verify and engine_request spans."""
    engine = _engine(model, params, draft=(model, params), k=K,
                     name="spec-obs")
    prompt, key = _prompts(8, seed=5)[0], _keys(1, base=780)[0]
    try:
        engine.submit(prompt, rng=key).result(timeout=120)
    finally:
        engine.stop()
    text = obs_metrics.render()
    for fam in ("kft_engine_spec_drafted_tokens_total",
                "kft_engine_spec_accepted_tokens_total",
                "kft_engine_spec_rejected_tokens_total"):
        assert fam in text
    spans = [s for s in tracing.TRACER.snapshot()
             if (s.get("args") or {}).get("model") == "spec-obs"]
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    slice_span = by_name["engine_slice"][0]["args"]
    assert slice_span["spec"] is True
    assert slice_span["drafted"] >= K
    assert slice_span["draft_ms"] >= 0.0
    assert slice_span["verify_ms"] > 0.0
    assert by_name["spec_verify"], "no spec_verify span"
    req_span = by_name["engine_request"][0]["args"]
    assert req_span["spec_drafted"] > 0
    assert req_span["verify_ms"] > 0.0


# -- chunked prefill: exactness + no-stall --------------------------------


@pytest.mark.parametrize("sampling", [{}, SAMPLED],
                         ids=["greedy", "sampled"])
def test_chunked_prefill_bitwise_matches_one_shot(model, params, jax_model,
                                                  jax_params, sampling):
    """Sliced admission == one-shot admission == B=1, for prompts landing
    on and off page boundaries, including a chunked admission joining
    mid-decode; and == the reference's chunked engine."""
    kw = dict(page_size=8, prefix_cache=True, **sampling)
    one_shot = _engine(model, params, name="chunk-ref", **kw)
    chunked = _engine(model, params, name="chunk-cut", prefill_chunk=8,
                      **kw)
    prompts = _prompts(17, 24, 9, seed=6)  # straddle + exact + sub
    keys = _keys(3, base=800)
    got = []
    try:
        # Occupy a decode slot first so the chunked admissions
        # interleave with live decode laps (the mid-decode join).
        churn_key = _keys(1, base=820)[0]
        churn = [e.submit(prompts[0], rng=churn_key)
                 for e in (one_shot, chunked)]
        for p, key in zip(prompts, keys):
            want = _reference(model, params, p, key, NEW_TOKENS,
                              left_pad=False, **sampling)
            got_one = one_shot.submit(p, rng=key).result(120)
            got_cut = chunked.submit(p, rng=key).result(120)
            np.testing.assert_array_equal(got_cut, got_one)
            np.testing.assert_array_equal(got_cut, want)
            got.append(got_cut)
        for s in churn:
            s.result(120)
        assert chunked.stats()["prefill_chunk"] == 8
        _assert_pool_clean(chunked)
    finally:
        one_shot.stop()
        chunked.stop()
    ref = _jax_tokens(jax_model, jax_params, list(zip(prompts, keys)),
                      prefill_chunk=8, **kw)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_spec_and_chunked_prefill_compose_bitwise(model, params):
    """Both lanes on one engine: a long chunked admission joins while
    speculative rounds run, and everything stays equal to B=1."""
    engine = _engine(model, params, draft=(model, params), k=K,
                     name="spec-chunk", page_size=8, prefix_cache=True,
                     prefill_chunk=8)
    prompts = _prompts(6, 21, seed=7)
    keys = _keys(2, base=840)
    try:
        streams = [engine.submit(p, rng=k) for p, k in zip(prompts, keys)]
        for p, key, s in zip(prompts, keys, streams):
            np.testing.assert_array_equal(
                s.result(timeout=120),
                _reference(model, params, p, key, NEW_TOKENS,
                           left_pad=False))
        assert engine.stats()["spec"]["rounds"] > 0
        _assert_pool_clean(engine)
    finally:
        engine.stop()


def test_chunked_4k_prompt_cannot_stall_decode_neighbor(jax_params):
    """The no-head-of-line acceptance: with a 4k-token prompt admitted
    in 256-token chunks, a decoding neighbour's inter-token gap stays
    bounded by about one chunk and a slice, NOT the whole prefill, and
    the interleave runs no shape it had not run (the chunk widths were
    warmed; compiled_programs counts first-seen shapes)."""
    cache = 4096 + NEW_TOKENS + 48
    model = llama_test(dtype="float32", cache_size=cache)
    params = _to_port(jax_params, model)
    engine = _engine(model, params, name="chunk-4k", slots=2,
                     max_prompt=4096, page_size=64, slice_tokens=4,
                     prefix_cache=True, prefill_chunk=256)
    rng = np.random.RandomState(8)
    short = rng.randint(0, 512, (16,)).astype(np.int32)
    long_a = rng.randint(0, 512, (4096,)).astype(np.int32)
    long_b = rng.randint(0, 512, (4096,)).astype(np.int32)
    try:
        # Warm every shape off the clock: a short decode and one full 4k
        # chunked prefill; then drop its registered pages so the measured
        # prefill pays all 16 chunks again.
        engine.submit(short).result(timeout=600)
        engine.submit(long_a).result(timeout=600)
        engine.clear_prefix_cache()
        programs_warm = engine.stats()["compiled_programs"]

        stream_a = engine.submit(short)
        first = stream_a.next_event(timeout=120)
        assert first is not None
        t_b0 = time.perf_counter()
        stream_b = engine.submit(long_b)
        gaps, last = [], time.perf_counter()
        for ev in stream_a.events(timeout_per_event=120):
            now = time.perf_counter()
            gaps.append(now - last)
            last = now
            if ev.final:
                break
        assert stream_b.next_event(timeout=600) is not None
        ttft_b = time.perf_counter() - t_b0
        stream_a.result(120)
        stream_b.result(600)
        assert max(gaps) < 0.5 * ttft_b, (max(gaps), ttft_b)
        assert engine.stats()["compiled_programs"] == programs_warm, \
            "interleaving a chunked prefill ran a new shape"
        _assert_pool_clean(engine)
    finally:
        engine.stop()


# -- the verify forward against the reference model -----------------------


def test_verify_forward_matches_the_reference(model, params, jax_model,
                                              jax_params):
    """One verify forward (``decode_positions`` with l = k + 1) over a
    cache holding rows at different positions: logits within the Llama
    parity tolerance of the reference's, the same cache rows written,
    and each column j equal to the one-token step at ``start + j`` run
    on a cache that holds the block's earlier tokens."""
    rng = np.random.default_rng(1)
    b, l = 3, K + 1
    ks = rng.standard_normal((2, 2, b, CACHE, 2, 16)).astype(np.float32)
    block = rng.integers(0, 512, (b, l)).astype(np.int32)
    start = np.asarray([4, 11, 30], np.int32)
    pad = np.asarray([0, 2, 5], np.int32)
    positions = (start - pad)[:, None] + np.arange(l, dtype=np.int32)
    jcache = jax_init_cache(jax_model, jax_params, b)
    for i in range(2):
        layer = jcache[f"layer_{i}"]["attention"]
        layer["k"], layer["v"] = jnp.asarray(ks[i, 0]), jnp.asarray(ks[i, 1])
    want, mutated = jax_model.apply(
        {"params": jax_params, "cache": jcache}, jnp.asarray(block),
        jnp.asarray(positions), mutable=["cache"],
        pad_lengths=jnp.asarray(pad), decode_positions=jnp.asarray(start))

    def port_cache():
        cache = init_cache(model, params, b)
        for i in range(2):
            cache[i].k.copy_(torch.from_numpy(ks[i, 0]))
            cache[i].v.copy_(torch.from_numpy(ks[i, 1]))
        return cache

    cache = port_cache()
    with torch.inference_mode():
        got = apply(model, params, torch.from_numpy(block),
                    torch.from_numpy(positions),
                    pad_lengths=torch.from_numpy(pad),
                    decode_positions=torch.from_numpy(start), cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    for i in range(2):
        ref_k = np.asarray(mutated["cache"][f"layer_{i}"]["attention"]["k"])
        np.testing.assert_allclose(cache[i].k.numpy(), ref_k, atol=1e-5)
        assert cache[i].index == 0
    # Column j against the one-token step at start + j.
    steps = port_cache()
    with torch.inference_mode():
        for j in range(l):
            step = apply(model, params, torch.from_numpy(block[:, j:j + 1]),
                         torch.from_numpy(positions[:, j:j + 1]),
                         pad_lengths=torch.from_numpy(pad),
                         decode_positions=torch.from_numpy(start + j),
                         cache=steps)
            np.testing.assert_allclose(got[:, j].numpy(), step[:, 0].numpy(),
                                       atol=1e-5, rtol=1e-5)


def test_verify_block_past_the_cache_end_moves_no_valid_kv(model, params):
    """A verify block that runs past the cache end (the last round of a
    request whose budget ends there): the columns inside the cache equal
    the one-token steps at their positions, and the K/V before the block
    stays as it was (a clamped write would move the block back over it)."""
    rng = np.random.default_rng(2)
    b, l = 2, K + 1
    ks = rng.standard_normal((2, 2, b, CACHE, 2, 16)).astype(np.float32)
    block = rng.integers(0, 512, (b, l)).astype(np.int32)
    start = np.asarray([CACHE - 2, 7], np.int32)
    positions = start[:, None] + np.arange(l, dtype=np.int32)

    def port_cache():
        cache = init_cache(model, params, b)
        for i in range(2):
            cache[i].k.copy_(torch.from_numpy(ks[i, 0]))
            cache[i].v.copy_(torch.from_numpy(ks[i, 1]))
        return cache

    cache = port_cache()
    with torch.inference_mode():
        got = apply(model, params, torch.from_numpy(block),
                    torch.from_numpy(positions),
                    decode_positions=torch.from_numpy(start), cache=cache)
        steps = port_cache()
        for j in range(2):  # both rows' columns 0 and 1 are in the cache
            step = apply(model, params, torch.from_numpy(block[:, j:j + 1]),
                         torch.from_numpy(positions[:, j:j + 1]),
                         decode_positions=torch.from_numpy(start + j),
                         cache=steps)
            np.testing.assert_allclose(got[:, j].numpy(), step[:, 0].numpy(),
                                       atol=1e-5, rtol=1e-5)
    for i in range(2):
        np.testing.assert_array_equal(cache[i].k[0, :CACHE - 2].numpy(),
                                      ks[i, 0, 0, :CACHE - 2])


def test_verify_block_starting_past_the_cache_end_writes_nothing(model,
                                                                 params):
    """A row whose block starts past the cache end (an overshooting row,
    whose tokens are discarded) indexes no cell outside the cache and
    leaves its K/V as it was; the other row's columns equal the
    one-token steps at their positions."""
    rng = np.random.default_rng(3)
    b, l = 2, K + 1
    ks = rng.standard_normal((2, 2, b, CACHE, 2, 16)).astype(np.float32)
    block = rng.integers(0, 512, (b, l)).astype(np.int32)
    start = np.asarray([CACHE + 3, 7], np.int32)
    positions = start[:, None] + np.arange(l, dtype=np.int32)

    def port_cache():
        cache = init_cache(model, params, b)
        for i in range(2):
            cache[i].k.copy_(torch.from_numpy(ks[i, 0]))
            cache[i].v.copy_(torch.from_numpy(ks[i, 1]))
        return cache

    cache = port_cache()
    with torch.inference_mode():
        got = apply(model, params, torch.from_numpy(block),
                    torch.from_numpy(positions),
                    decode_positions=torch.from_numpy(start), cache=cache)
        steps = port_cache()
        for j in range(l):
            step = apply(model, params, torch.from_numpy(block[:, j:j + 1]),
                         torch.from_numpy(positions[:, j:j + 1]),
                         decode_positions=torch.from_numpy(start + j),
                         cache=steps)
            np.testing.assert_allclose(got[1, j].numpy(), step[1, 0].numpy(),
                                       atol=1e-5, rtol=1e-5)
    assert torch.isfinite(got).all()
    for i in range(2):
        np.testing.assert_array_equal(cache[i].k[0].numpy(), ks[i, 0, 0])
        np.testing.assert_array_equal(cache[i].v[0].numpy(), ks[i, 1, 0])


@pytest.mark.parametrize("sampling", [{}, SAMPLED],
                         ids=["greedy", "sampled"])
def test_spec_streams_equal_b1_when_budgets_end_at_the_cache_end(
        jax_params, sampling):
    """The cache holds exactly the prompt bucket and the budget, so the
    last rounds' verify blocks run past its end: every stream still
    equals B=1."""
    model = llama_test(dtype="float32", cache_size=24)
    params = _to_port(jax_params, model)
    engine = _engine(model, params, draft=(model, params), k=4,
                     name="spec-cache-end", max_prompt=16, new_tokens=8,
                     slots=2, **sampling)
    prompts = _prompts(9, 16, 12, seed=15)
    keys = _keys(3, base=940)
    try:
        streams = [engine.submit(p, rng=k) for p, k in zip(prompts, keys)]
        for p, key, s in zip(prompts, keys, streams):
            want = prompt_bucket(len(p), 16)
            ids = np.zeros((1, want), np.int32)
            ids[0, want - len(p):] = p
            ref, _ = generate(model, params, torch.from_numpy(ids),
                              max_new_tokens=8, rng=key[None],
                              prompt_lengths=torch.tensor([len(p)]),
                              **sampling)
            np.testing.assert_array_equal(s.result(timeout=120),
                                          ref[0].numpy())
        _assert_pool_clean(engine)
    finally:
        engine.stop()


# -- a draft export through ensure_engine ---------------------------------


def _generate_metadata(model_name, kwargs, generate_config):
    return ModelMetadata(
        model_name=model_name, registry_name="llama-test",
        model_kwargs=kwargs,
        signatures={"serving_default": Signature(
            method="generate",
            inputs={"input_ids": TensorSpec("int32", (-1, MAX_PROMPT))},
            outputs={"tokens": TensorSpec("int32", (-1, NEW_TOKENS))})},
        generate_config=generate_config)


@pytest.mark.parametrize("draft_present", [True, False],
                         ids=["jax_draft_export", "missing_draft"])
def test_draft_export_through_ensure_engine(tmp_path, model, params,
                                            jax_params, draft_present):
    """A draft export written by the reference's ``export_model`` serves
    through the port's ``ensure_engine`` as the speculative draft; a
    missing one degrades to vanilla decoding. The streams equal B=1
    either way."""
    kwargs = {"dtype": "float32", "cache_size": CACHE}
    draft_dir = tmp_path / "draft"
    if draft_present:
        meta = _generate_metadata("draft", kwargs, {})
        jax_export_model(str(draft_dir), 1, JaxMetadata.loads(meta.dumps()),
                         {"params": jax_params})
    cfg = dict(max_new_tokens=NEW_TOKENS, temperature=0.0, engine_slots=2,
               engine_page_size=4, engine_slice_tokens=4,
               engine_draft_tokens=K,
               engine_draft_export=str(draft_dir / "1"))
    loaded = LoadedModel(_generate_metadata("verifier", kwargs, cfg), 1,
                         params, max_batch=2, device="cpu")
    prompts = _prompts(5, 11, seed=11)
    keys = _keys(2, base=880)
    try:
        engine = loaded.ensure_engine()
        assert ("spec" in engine.stats()) is draft_present
        streams = [engine.submit(p, rng=k) for p, k in zip(prompts, keys)]
        for p, key, s in zip(prompts, keys, streams):
            np.testing.assert_array_equal(
                s.result(timeout=120),
                _reference(model, params, p, key, NEW_TOKENS))
        if draft_present:
            assert engine.stats()["spec"]["acceptance_rate"] > 0.5
    finally:
        loaded.close()


# -- multi-token append/rollback accounting fuzz --------------------------


def test_append_truncate_fuzz_invariants_and_drain_to_zero():
    """Randomized spec rounds over a tiny pool: admit (with prefix pins)
    → repeated extend-by-(k+1) / accept-some / truncate cycles × random
    cancels, allocator and index invariants checked after EVERY step,
    then drain to zero resident pages."""
    rng = np.random.RandomState(16)
    P, CACHE_SLOTS, SLOTS = 4, 24, 3
    template = [LayerCache(torch.zeros((1, CACHE_SLOTS, 2, 2)),
                           torch.zeros((1, CACHE_SLOTS, 2, 2)))]
    kv = PagedKVCache(template, num_slots=SLOTS, page_size=P,
                      cache_size=CACHE_SLOTS, num_pages=14)
    alloc = kv.allocator
    cache = PrefixCache(P, alloc)
    bases = [list(rng.randint(0, 50, (8,))) for _ in range(2)]
    prompts = [b + list(rng.randint(0, 50, (rng.randint(0, 5),)))
               for b in bases for _ in range(4)]
    free_slots = list(range(SLOTS))
    live = {}  # slot -> dict(allocated, budget, wpos, remaining)

    def check():
        alloc.check_invariants()
        cache.check_invariants()

    def try_admit(prompt):
        remaining = int(rng.randint(2, 9))
        budget = kv.pages_for(len(prompt) + remaining + K)
        match = cache.pin(cache.match(prompt))
        if not alloc.reserve(budget - len(match.entries)):
            cache.unpin(match)
            return False
        cache.unpin_fork(match)
        shared = len(match.entries)
        idx = free_slots.pop()
        kv.tables[idx, :shared] = match.shared_pages
        allocated = kv.extend_slot(idx, shared, len(prompt), budget)
        cache.register(prompt, kv.tables[idx, :allocated].tolist())
        live[idx] = dict(allocated=allocated, budget=budget,
                         wpos=len(prompt), remaining=remaining)
        return True

    def spec_round(idx):
        s = live[idx]
        s["allocated"] = kv.extend_slot(
            idx, s["allocated"], s["wpos"] + K + 1, s["budget"])
        take = min(int(rng.randint(1, K + 2)), s["remaining"])
        s["wpos"] += take
        s["remaining"] -= take
        s["allocated"] = kv.truncate_slot(idx, s["allocated"], s["wpos"])
        if s["remaining"] == 0:
            retire(idx)

    def retire(idx):
        s = live.pop(idx)
        kv.release_slot(idx, s["allocated"], s["budget"] - s["allocated"])
        free_slots.append(idx)

    for _ in range(800):
        op = rng.rand()
        if op < 0.4 and free_slots:
            try_admit(prompts[rng.randint(len(prompts))])
        elif op < 0.9 and live:
            spec_round(int(rng.choice(list(live))))
        elif live:  # cancel mid-flight
            retire(int(rng.choice(list(live))))
        check()

    for idx in list(live):
        retire(idx)
        check()
    cache.clear()
    check()
    assert alloc.free_pages == 13, alloc.free_pages
    assert alloc.reserved_pages == 0
    assert not np.any(kv.tables), kv.tables


def test_stats_spec_block_and_chunk_key_equal_the_reference(
        model, params, jax_model, jax_params):
    """``stats()`` of a spec + chunk engine has the reference's keys,
    ``spec`` block included."""
    kw = dict(k=K, page_size=8, prefix_cache=True, prefill_chunk=8)
    port = _engine(model, params, draft=(model, params), name="st-port",
                   **kw)
    ref = JaxDecodeEngine(jax_model, jax_params,
                          JaxEngineConfig(**_config(**kw)), name="st-jax",
                          draft_model=jax_model, draft_params=jax_params)
    try:
        assert set(port.stats()) == set(ref.stats())
        assert set(port.stats()["spec"]) == set(ref.stats()["spec"])
        assert port.stats()["prefill_chunk"] == 8
    finally:
        port.stop()
        ref.stop()


def test_chunked_prefill_retired_mid_prefill_releases_everything(
        model, params):
    """A chunked prefill cancelled before its last chunk unpins its
    prefix match and returns its reservation: the pool drains clean."""
    engine = _engine(model, params, name="chunk-cancel", page_size=4,
                     prefix_cache=True, prefill_chunk=4, slots=2)
    prompt = _prompts(22, seed=12)[0]
    target = []
    advance = engine._advance_prefills

    def cancel_after_a_chunk():
        # The target is cancelled once its first chunk past the match
        # has run; the next lap's expiry retires it mid-prefill.
        for slot in engine.scheduler.prefilling_slots():
            if target and slot.request.stream is target[0] and \
                    slot.prefill_pos > slot.prefill_match.matched:
                target[0].cancel()
        advance()

    engine._advance_prefills = cancel_after_a_chunk
    try:
        # Warm the index with the prompt's head, so the cancelled
        # admission holds pinned prefix pages.
        engine.submit(prompt[:9], rng=_keys(1)[0]).result(120)
        target.append(engine.submit(prompt, rng=_keys(1, base=5)[0]))
        with pytest.raises(RuntimeError, match="cancelled"):
            target[0].result(120)
        assert engine.scheduler.retired_by.get("cancelled") == 1
        _assert_pool_clean(engine)
        engine.prefix.check_invariants()
    finally:
        engine.stop()


def test_spec_round_rolls_back_to_the_accepted_length(model, params,
                                                      weak_draft):
    """After every speculative round a slot holds exactly the pages its
    accepted length needs (``truncate_slot``), whatever it extended to."""
    engine = _engine(model, params, draft=weak_draft, k=K,
                     name="spec-rollback", slots=1)
    seen = []
    real = engine.kv.truncate_slot

    def spy(slot_index, allocated, keep):
        out = real(slot_index, allocated, keep)
        seen.append((out, engine.kv.pages_for(keep)))
        return out

    engine.kv.truncate_slot = spy
    try:
        prompt, key = _prompts(6, seed=13)[0], _keys(1, base=900)[0]
        np.testing.assert_array_equal(
            engine.submit(prompt, rng=key).result(120),
            _reference(model, params, prompt, key, NEW_TOKENS))
        assert seen and all(out == need for out, need in seen), seen
    finally:
        engine.stop()


def test_weak_draft_proposals_never_change_the_targets(model, params,
                                                       weak_draft):
    """The same request through a weak-draft and a strong-draft engine:
    equal streams, different acceptance."""
    prompt, key = _prompts(9, seed=14)[0], _keys(1, base=920)[0]
    out, rates = [], []
    for name, draft in (("weak", weak_draft), ("strong", (model, params))):
        engine = _engine(model, params, draft=draft, k=K,
                         name=f"spec-{name}-pair", **SAMPLED)
        try:
            out.append(engine.submit(prompt, rng=key).result(120))
            rates.append(engine.stats()["spec"]["acceptance_rate"])
        finally:
            engine.stop()
    np.testing.assert_array_equal(out[0], out[1])
    assert rates[0] < rates[1]


def test_draft_cache_row_lands_in_its_slot():
    """``_insert_cache_row`` writes a B=1 cache's K/V into one row of
    the draft's batched cache and touches no other row."""
    from kubeflow_tpu_torch.inference.engine.engine import _insert_cache_row

    batched = [LayerCache(torch.zeros(3, 8, 2, 4), torch.zeros(3, 8, 2, 4))]
    single = [LayerCache(torch.ones(1, 8, 2, 4), 2 * torch.ones(1, 8, 2, 4),
                         index=5)]
    _insert_cache_row(batched, single, 1)
    assert torch.equal(batched[0].k[1], single[0].k[0])
    assert torch.equal(batched[0].v[1], single[0].v[0])
    assert not batched[0].k[0].any() and not batched[0].k[2].any()
    assert batched[0].index == 0


def test_engine_config_round_trips_the_lane_knobs():
    cfg = EngineConfig.from_generate_config(
        {"engine_draft_tokens": 4, "engine_prefill_chunk": 64}, 512)
    assert dataclasses.asdict(cfg)["speculate_tokens"] == 4
    assert cfg.prefill_chunk == 64
