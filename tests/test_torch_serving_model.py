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

"""``LoadedModel.run`` in kubeflow_tpu_torch vs kubeflow_tpu.

Both are built in the test from the same ``llama-test`` fp32 params
(the reference's, carried across). Predict logits and classify scores
agree within 1e-4 (the Llama parity tolerance); classify classes and
greedy and sampled generate tokens are identical, and so are the
per-row keys ``request_rngs`` mints. The continuous-batching engine
that ``ensure_engine`` builds streams the tokens ``run`` gives at B=1.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

from kubeflow_tpu.serving.model import LoadedModel as JaxLoadedModel
from kubeflow_tpu.serving.signature import ModelMetadata as JaxMetadata
from kubeflow_tpu_torch.inference import prng
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.serving.model import LoadedModel
from kubeflow_tpu_torch.serving.signature import (
    ModelMetadata,
    Signature,
    TensorSpec,
)

SEQ = 16
MAX_PROMPT = 8
NEW = 5
CACHE = 16
TOL = dict(atol=1e-4, rtol=1e-4)


def _metadata(method, kwargs, seq, out):
    return ModelMetadata(
        model_name="tiny", registry_name="llama-test", model_kwargs=kwargs,
        signatures={"serving_default": Signature(
            method=method,
            inputs={"input_ids": TensorSpec("int32", (-1, seq))},
            outputs=out)},
        generate_config=({"max_new_tokens": NEW, "temperature": 0.0}
                         if method == "generate" else {}))


@pytest.fixture(scope="module")
def flax_params():
    from kubeflow_tpu.models.llama import llama_test

    variables = llama_test(dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return nn.meta.unbox(variables["params"])


def _pair(flax_params, method, kwargs, seq, out, max_batch=4,
          generate_config=None):
    meta = _metadata(method, kwargs, seq, out)
    if generate_config is not None:
        meta = dataclasses.replace(meta, generate_config=generate_config)
    jax_meta = JaxMetadata.loads(meta.dumps())  # the same JSON both ways
    jax_model = JaxLoadedModel(jax_meta, 1, {"params": flax_params},
                               max_batch=max_batch, top_k=3)
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(flax_params, sep="/").items()}
    template = get_model("llama-test").make(**kwargs)
    params = convert.params_from_flax(flat, template, device="cpu")
    model = LoadedModel(meta, 1, params, max_batch=max_batch, top_k=3,
                        device="cpu")
    return jax_model, model


def _ids(seed, n, l):
    return np.random.default_rng(seed).integers(1, 512, (n, l)).astype(
        np.int32)


# n=3 pads to the batch bucket of 4; n=6 is split at max_batch 4.
@pytest.mark.parametrize("n", [1, 3, 6])
def test_predict_and_classify_match_reference(flax_params, n):
    jax_model, model = _pair(flax_params, "predict", {"dtype": "float32"},
                             SEQ, {"logits": TensorSpec("float32",
                                                        (-1, SEQ, 512))})
    x = {"input_ids": _ids(n, n, SEQ)}
    ref = jax_model.run(x, method="predict")
    out = model.run(x, method="predict")
    assert out["logits"].shape == (n, SEQ, 512)
    np.testing.assert_allclose(out["logits"], ref["logits"], **TOL)
    ref = jax_model.run(x, method="classify")
    out = model.run(x, method="classify")
    np.testing.assert_array_equal(out["classes"], ref["classes"])
    assert out["classes"].dtype == np.int32
    np.testing.assert_allclose(out["scores"], ref["scores"], **TOL)


def test_generate_matches_reference(flax_params):
    kwargs = {"dtype": "float32", "cache_size": CACHE}
    jax_model, model = _pair(
        flax_params, "generate", kwargs, MAX_PROMPT,
        {"tokens": TensorSpec("int32", (-1, NEW))})
    # Three prompts of width 5 → left-padded to the length bucket 8 and
    # the batch bucket 4; the per-row lengths mix 2..5.
    x = {"input_ids": _ids(7, 3, 5)}
    lengths = np.array([5, 2, 4], np.int32)
    ref = jax_model.run(x, prompt_lengths=lengths)
    out = model.run(x, prompt_lengths=lengths)
    assert out["tokens"].shape == (3, NEW)
    np.testing.assert_array_equal(out["tokens"], ref["tokens"])


def test_method_and_shape_errors(flax_params):
    _, model = _pair(flax_params, "predict", {"dtype": "float32"}, SEQ,
                     {"logits": TensorSpec("float32", (-1, SEQ, 512))})
    with pytest.raises(ValueError, match="incompatible"):
        model.run({"input_ids": _ids(0, 1, SEQ)}, method="generate")
    with pytest.raises(ValueError, match="shape"):
        model.run({"input_ids": _ids(0, 1, SEQ - 1)})
    with pytest.raises(ValueError, match="missing input"):
        model.run({"tokens": _ids(0, 1, SEQ)})


def test_warmup_sets_batch_seconds(flax_params):
    _, model = _pair(flax_params, "predict", {"dtype": "float32"}, SEQ,
                     {"logits": TensorSpec("float32", (-1, SEQ, 512))},
                     max_batch=2)
    assert model.warmup_batch_seconds is None
    model.warmup()
    assert model.warmup_batch_seconds > 0


def test_signature_json_round_trips_with_reference():
    meta = _metadata("generate", {"dtype": "float32", "cache_size": CACHE},
                     MAX_PROMPT, {"tokens": TensorSpec("int32", (-1, NEW))})
    assert JaxMetadata.loads(meta.dumps()).to_json() == meta.to_json()
    assert ModelMetadata.loads(
        JaxMetadata.loads(meta.dumps()).dumps()) == meta


GEN_KWARGS = {"dtype": "float32", "cache_size": CACHE}
GEN_OUT = {"tokens": TensorSpec("int32", (-1, NEW))}
SAMPLED = {"max_new_tokens": NEW, "temperature": 0.8, "top_k": 50,
           "top_p": 0.95, "seed": 3}


@pytest.mark.parametrize("deterministic", [True, False])
def test_request_rngs_match_reference(flax_params, deterministic):
    jax_model, model = _pair(flax_params, "generate", GEN_KWARGS, MAX_PROMPT,
                             GEN_OUT, generate_config=dict(
                                 SAMPLED, deterministic=deterministic))
    for n in (1, 3, 3):
        got = model.request_rngs(n)
        assert got.dtype == np.uint32 and got.shape == (n, 2)
        np.testing.assert_array_equal(got, jax_model.request_rngs(n))


@pytest.mark.parametrize("row_rngs", [False, True])
def test_sampled_generate_matches_reference(flax_params, row_rngs):
    jax_model, model = _pair(flax_params, "generate", GEN_KWARGS, MAX_PROMPT,
                             GEN_OUT, generate_config=SAMPLED)
    x = {"input_ids": _ids(9, 3, 6)}
    lengths = np.array([6, 3, 5], np.int32)
    kw = {}
    if row_rngs:
        kw["row_rngs"] = np.stack([prng.PRNGKey(40 + i) for i in range(3)])
    ref = jax_model.run(x, prompt_lengths=lengths, **kw)
    out = model.run(x, prompt_lengths=lengths, **kw)
    np.testing.assert_array_equal(out["tokens"], ref["tokens"])


@pytest.mark.parametrize("generate_config", [
    {"max_new_tokens": NEW, "temperature": 0.0}, SAMPLED],
    ids=["greedy", "sampled"])
def test_engine_streams_equal_run(flax_params, generate_config):
    _, model = _pair(flax_params, "generate", GEN_KWARGS, MAX_PROMPT,
                     GEN_OUT, generate_config=dict(
                         generate_config, engine_slots=2, engine_page_size=4,
                         engine_slice_tokens=2))
    engine = model.ensure_engine()
    try:
        assert model.engine is engine and model.ensure_engine() is engine
        assert engine.config.num_slots == 2 and engine.kv.page_size == 4
        prompts = [_ids(20 + i, 1, n)[0] for i, n in enumerate((3, 8, 5))]
        keys = [prng.PRNGKey(60 + i) for i in range(3)]
        streams = [engine.submit(p, rng=k) for p, k in zip(prompts, keys)]
        for p, k, s in zip(prompts, keys, streams):
            want = model.run({"input_ids": p[None]},
                             row_rngs=k[None])["tokens"][0]
            np.testing.assert_array_equal(s.result(timeout=120.0), want)
    finally:
        model.close()
    assert model.engine is None
    model.close()  # idempotent


def test_engine_prefix_cache_rides_the_export(flax_params):
    """``engine_prefix_cache`` in the export's generate_config builds the
    prefix lane: a second request sharing the first's prompt head hits,
    and both streams equal the reference engine's on the same export."""
    cfg = dict(SAMPLED, engine_slots=2, engine_page_size=4,
               engine_slice_tokens=2, engine_prefix_cache=True)
    jax_model, model = _pair(flax_params, "generate", GEN_KWARGS,
                             MAX_PROMPT, GEN_OUT, generate_config=cfg)
    head = _ids(30, 1, 5)[0]
    prompts = [np.concatenate([head, _ids(31 + i, 1, 2 + i)[0]])
               for i in range(2)]
    keys = [prng.PRNGKey(70 + i) for i in range(2)]
    out = {}
    for name, loaded in (("port", model), ("jax", jax_model)):
        engine = loaded.ensure_engine()
        try:
            assert engine.prefix is not None
            out[name] = [engine.submit(p, rng=k).result(timeout=120.0)
                         for p, k in zip(prompts, keys)]
            stats = engine.stats()["prefix_cache"]
            assert stats["hits"] == 1 and stats["misses"] == 1, stats
        finally:
            loaded.close()
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(a, b)


def test_ensure_engine_refuses_what_it_cannot_serve(flax_params):
    _, predict = _pair(flax_params, "predict", {"dtype": "float32"}, SEQ,
                       {"logits": TensorSpec("float32", (-1, SEQ, 512))})
    with pytest.raises(ValueError, match="generate-method"):
        predict.ensure_engine()
    # A negative host-tier budget, and chunked prefill without the
    # prefix cache, are the reference's config errors.
    for extra, error, match in (
            ({"engine_prefix_cache": True,
              "engine_host_cache_bytes": -1}, ValueError,
             "0 disables the host tier"),
            ({"engine_prefill_chunk": 8}, ValueError,
             "requires engine_prefix_cache")):
        _, model = _pair(flax_params, "generate", GEN_KWARGS, MAX_PROMPT,
                         GEN_OUT, generate_config=dict(SAMPLED, **extra))
        with pytest.raises(error, match=match):
            model.ensure_engine()
        assert model.engine is None
    # The host tier on top of the prefix lane reaches the engine.
    _, model = _pair(flax_params, "generate", GEN_KWARGS, MAX_PROMPT,
                     GEN_OUT, generate_config=dict(
                         SAMPLED, engine_prefix_cache=True,
                         engine_host_cache_bytes=1 << 20))
    try:
        assert model.ensure_engine().host_tier.budget_bytes == 1 << 20
    finally:
        model.close()
    # A draft export that does not load degrades to vanilla decoding, as
    # the reference's does.
    _, model = _pair(flax_params, "generate", GEN_KWARGS, MAX_PROMPT,
                     GEN_OUT, generate_config=dict(
                         SAMPLED, engine_draft_tokens=2,
                         engine_draft_export="/nowhere"))
    try:
        assert "spec" not in model.ensure_engine().stats()
    finally:
        model.close()

