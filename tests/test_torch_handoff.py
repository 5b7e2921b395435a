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

"""KV handoff in the port against the reference.

Twins of tests/test_role_routing.py's engine handoff seam (a handoff
adopted on another engine equals the local stream, greedy and a short
budget, blob validation), of tests/test_spec_decode.py's prefill-role
``run_prefill`` in the prefix lane and of tests/test_prefix_cache.py's
warm transfer, on ``llama-test`` fp32 with the reference's params
carried across. Then the blobs cross backends: a handoff the port's
``run_prefill`` wrote decodes in the reference's ``wire`` and its engine
adopts it to its own local stream, and the reverse, in both layouts,
greedy and sampled, with the same keys.
"""

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
from kubeflow_tpu.models.llama import llama_test as jax_llama_test
from kubeflow_tpu.serving import wire as jax_wire
from kubeflow_tpu_torch.inference import prng
from kubeflow_tpu_torch.inference.engine import (
    DecodeEngine,
    EngineConfig,
    PrefillHandoff,
)
from kubeflow_tpu_torch.inference.generate import generate
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.llama import LayerCache, llama_test
from kubeflow_tpu_torch.serving import wire

PROMPT_LEN = 8
NEW_TOKENS = 6
CACHE = 32
PAGE = 4
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)


@pytest.fixture(scope="module")
def jax_model():
    return jax_llama_test(dtype=jnp.float32, cache_size=CACHE)


@pytest.fixture(scope="module")
def jax_params(jax_model):
    ids = jnp.zeros((1, PROMPT_LEN), jnp.int32)
    return nn.meta.unbox(jax_model.init(jax.random.PRNGKey(0), ids)["params"])


@pytest.fixture(scope="module")
def model():
    return llama_test(dtype="float32", cache_size=CACHE)


@pytest.fixture(scope="module")
def params(model, jax_params):
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(jax_params, sep="/").items()}
    return convert.params_from_flax(flat, model, device="cpu")


def _config(**kw):
    base = dict(max_new_tokens=NEW_TOKENS, max_prompt_len=PROMPT_LEN,
                temperature=0.8, num_slots=2, page_size=PAGE,
                slice_tokens=2, seed=0)
    base.update(kw)
    return base


def _engine(model, params, name, **kw):
    return DecodeEngine(model, params, EngineConfig(**_config(**kw)),
                        name=name, device="cpu")


def _prompt(seed, n=PROMPT_LEN):
    return np.random.RandomState(seed).randint(0, 512, (n,)).astype(
        np.int32)


def _b1(model, params, prompt, key, budget, **sampling):
    """B=1 ``generate`` of the unpadded prompt (the pad-0 layout)."""
    tokens, _ = generate(
        model, params, torch.from_numpy(prompt)[None],
        max_new_tokens=budget, rng=key[None],
        prompt_lengths=torch.tensor([len(prompt)]), **sampling)
    return tokens[0].numpy()


# -- the handoff seam, in the port ------------------------------------------


def test_handoff_resumes_bitwise_across_engines(model, params):
    a, b = _engine(model, params, "h-a"), _engine(model, params, "h-b")
    try:
        prompt = _prompt(3)
        key = prng.PRNGKey(7)
        local = a.submit(prompt, rng=key).result(timeout=120)
        handoff = a.run_prefill(prompt, rng=key)
        assert isinstance(handoff, PrefillHandoff)
        assert handoff.layout == "left" and handoff.prompt_tokens is None
        assert handoff.cache[0].k.device.type == "cpu"
        blob = wire.encode_kv_handoff("m", 1, handoff)
        resumed = b.submit(handoff=wire.decode_kv_handoff(
            blob, model="m", version=1)).result(timeout=120)
        np.testing.assert_array_equal(local, resumed)
        # A left-layout handoff carries no prompt ids: not resumable.
        assert b.stats()["retired"] == {"budget": 1}
        assert b.stats()["free_pages"] == b.stats()["total_pages"]
    finally:
        a.stop()
        b.stop()


def test_handoff_greedy_and_short_budget(model, params):
    eng = _engine(model, params, "h-g", temperature=0.0)
    try:
        prompt = np.asarray([5, 6, 7], np.int32)
        local = eng.submit(prompt, max_new_tokens=3).result(timeout=120)
        handoff = eng.run_prefill(prompt, max_new_tokens=3)
        stream = eng.submit(handoff=handoff)
        np.testing.assert_array_equal(local, stream.result(timeout=120))
        assert stream.resume_ctx is None
        # A caller budget that disagrees with the handoff's schedule is
        # rejected (it would fork the key schedule).
        with pytest.raises(ValueError, match="step-key"):
            eng.submit(handoff=handoff, max_new_tokens=5)
    finally:
        eng.stop()


def test_handoff_blob_validation(model, params):
    eng = _engine(model, params, "h-v")
    try:
        handoff = eng.run_prefill(np.asarray([5, 6, 7], np.int32))
        blob = wire.encode_kv_handoff("m", 3, handoff)
        with pytest.raises(ValueError, match="model"):
            wire.decode_kv_handoff(blob, model="other")
        with pytest.raises(ValueError, match="version 3"):
            wire.decode_kv_handoff(blob, model="m", version=4)
        with pytest.raises(ValueError, match="malformed"):
            wire.decode_kv_handoff(b"junk", model="m")
        # The engine's own checks: layout, width, length, schedule and
        # the cache's geometry.
        for change, match in (
                (dict(layout="right"), "layout"),
                (dict(prompt_width=64), "prompt_width"),
                (dict(prompt_len=9), "prompt_len"),
                (dict(step_keys=handoff.step_keys[:2]), "step keys"),
                (dict(cache=handoff.cache[:1]), "does not fit")):
            bad = PrefillHandoff(**{**vars(handoff), **change})
            with pytest.raises(ValueError, match=match):
                eng.submit(handoff=bad)
    finally:
        eng.stop()


def test_run_prefill_registers_and_hits_prefix_index(model, params):
    """A prefill-role engine's run_prefill binds a slot, registers its
    prompt in the prefix index and hits on a repeat; the right-layout
    handoff adopted on a decode-role engine equals B=1."""
    prefill = _engine(model, params, "h-prefill", prefix_cache=True,
                      prefill_chunk=8, temperature=0.0,
                      max_prompt_len=24, max_new_tokens=6)
    decode = _engine(model, params, "h-decode", prefix_cache=True,
                     temperature=0.0, max_prompt_len=24, max_new_tokens=6)
    rng = np.random.RandomState(9)
    base = rng.randint(0, 512, (12,)).astype(np.int32)
    prompts = [np.concatenate([base, rng.randint(0, 512, (4,)).astype(
        np.int32)]) for _ in range(2)]
    key = prng.PRNGKey(860)
    try:
        handoffs = [prefill.run_prefill(p, rng=key) for p in prompts]
        stats = prefill.stats()
        assert stats["prefix_cache"]["hits"] > 0, stats
        assert stats["retired"] == {"prefill_handoff": 2}, stats
        for p, handoff in zip(prompts, handoffs):
            assert handoff.layout == "right"
            assert handoff.prompt_width == handoff.prompt_len == len(p)
            np.testing.assert_array_equal(handoff.prompt_tokens, p)
            np.testing.assert_array_equal(
                decode.submit(handoff=handoff).result(timeout=120),
                _b1(model, params, p, key, 6))
        # The decode engine indexed the carried pages: the shared 12
        # tokens' three full blocks match (a match leaves the last
        # prompt token to prefill, so the fourth block does not).
        assert decode.probe_prefix(prompts[0]) == 12
    finally:
        prefill.stop()
        decode.stop()


def test_warm_transfer_roundtrip_registers_and_stays_bitwise(model, params):
    """Engine A prefills once; the blob carries the layout and the
    prompt; engine B adopts and indexes the pages, so its next request
    on the prefix hits. Both equal B=1; a left-layout blob is refused."""
    kw = dict(prefix_cache=True, temperature=0.0, max_prompt_len=20,
              max_new_tokens=9, slice_tokens=4)
    a = _engine(model, params, "h-warm-a", **kw)
    b = _engine(model, params, "h-warm-b", **kw)
    rng = np.random.RandomState(31)
    shared = rng.randint(0, 512, (10,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(0, 512, (n,)).astype(
        np.int32)]) for n in (3, 2)]
    keys = [prng.PRNGKey(2500 + i) for i in range(2)]
    try:
        handoff = a.run_prefill(prompts[0], rng=keys[0])
        carried = wire.decode_kv_handoff(
            wire.encode_kv_handoff("m", 1, handoff), model="m", version=1)
        assert carried.layout == "right"
        np.testing.assert_array_equal(carried.prompt_tokens, prompts[0])
        stream = b.submit(handoff=carried)
        np.testing.assert_array_equal(
            stream.result(120.0), _b1(model, params, prompts[0], keys[0], 9))
        np.testing.assert_array_equal(stream.resume_ctx["prompt"],
                                      prompts[0])
        before = b.stats()["prefix_cache"]["hits"]
        np.testing.assert_array_equal(
            b.submit(prompts[1], rng=keys[1]).result(120.0),
            _b1(model, params, prompts[1], keys[1], 9))
        assert b.stats()["prefix_cache"]["hits"] == before + 1
        left = PrefillHandoff(**{**vars(carried), "layout": "left"})
        with pytest.raises(ValueError, match="layout"):
            b.submit(handoff=left)
        for eng in (a, b):
            st = eng.stats()
            assert st["reserved_pages"] == 0 and not st["active_slots"]
            eng.kv.allocator.check_invariants()
            eng.prefix.check_invariants()
    finally:
        a.stop()
        b.stop()


def test_cache_bridge_matches_the_reference_cache_collection(
        model, params, jax_model, jax_params):
    """``cache_to_flax`` gives the reference's flat cache collection:
    the same keys, shapes and dtypes, and ``index`` the int32 scalar;
    ``cache_from_flax`` inverts it and rejects a partial tree."""
    ref = flatten_dict(jax.tree.map(np.asarray, jax_init_cache(
        jax_model, jax_params, 1)), sep="/")
    cache = [LayerCache(torch.randn(1, CACHE, 2, 16),
                        torch.randn(1, CACHE, 2, 16), 5)
             for _ in range(model.num_layers)]
    flat = convert.cache_to_flax(cache)
    assert set(flat) == set(ref)
    for k, v in ref.items():
        assert flat[k].shape == v.shape and flat[k].dtype == v.dtype, k
    back = convert.cache_from_flax(flat)
    for a, b in zip(cache, back):
        assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
        assert b.index == 5
    del flat["layer_1/attention/v"]
    with pytest.raises(ValueError, match="layer 1"):
        convert.cache_from_flax(flat)


# -- blobs across backends ----------------------------------------------------


@pytest.fixture(scope="module")
def engines(model, params, jax_model, jax_params):
    """Per (layout, sampling): a port engine and a reference engine of
    one config, built once."""
    made = {}

    def get(layout, sampling):
        key = (layout, sampling)
        if key not in made:
            kw = _config(prefix_cache=layout == "right",
                         **(SAMPLED if sampling == "sampled"
                            else dict(temperature=0.0)))
            made[key] = (
                DecodeEngine(model, params, EngineConfig(**kw),
                             name=f"hx-port-{layout}-{sampling}",
                             device="cpu"),
                JaxDecodeEngine(jax_model, jax_params, JaxEngineConfig(**kw),
                                name=f"hx-jax-{layout}-{sampling}"))
        return made[key]

    yield get
    for port, ref in made.values():
        port.stop()
        ref.stop()


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
@pytest.mark.parametrize("layout", ["left", "right"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_handoff_blob_crosses_backends(engines, direction, layout,
                                       sampling):
    """A handoff written by one package's ``run_prefill`` decodes in the
    other's ``wire`` and its engine's adopted stream equals that
    engine's own local stream (and the writer's), same keys."""
    port, ref = engines(layout, sampling)
    writer, reader = (port, ref) if direction == "port_to_jax" else (ref,
                                                                      port)
    encode = (wire if writer is port else jax_wire).encode_kv_handoff
    decode = (wire if reader is port else jax_wire).decode_kv_handoff
    prompt = _prompt(11 + (layout == "right"), n=PROMPT_LEN - 1)
    key = prng.PRNGKey(40)
    handoff = writer.run_prefill(prompt, rng=key)
    assert handoff.layout == layout
    carried = decode(encode("m", 2, handoff), model="m", version=2)
    assert carried.layout == layout
    adopted = reader.submit(handoff=carried).result(timeout=180)
    local_reader = reader.submit(prompt, rng=key).result(timeout=180)
    local_writer = writer.submit(prompt, rng=key).result(timeout=180)
    np.testing.assert_array_equal(adopted, local_reader)
    np.testing.assert_array_equal(adopted, local_writer)
