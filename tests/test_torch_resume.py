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

"""Mid-stream resume in the port against the reference.

Twins of tests/test_serving_faults.py's resume token and engine
continuation (the token's round trip and validation; a stream killed
after 1, 3 and budget - 1 tokens continued on a peer from the context
and the remaining step keys equals the rest of the uninterrupted stream,
greedy and sampled; the submit checks; a context longer than
``max_prompt_len``), in the classic and the prefix lane, on
``llama-test`` fp32 with the reference's params carried across. A
resume token the reference wrote resumes on the port's engine, and the
reverse, to the writer's uninterrupted stream.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict

from kubeflow_tpu.inference.engine import DecodeEngine as JaxDecodeEngine
from kubeflow_tpu.inference.engine import EngineConfig as JaxEngineConfig
from kubeflow_tpu.models.llama import llama_test as jax_llama_test
from kubeflow_tpu.serving import wire as jax_wire
from kubeflow_tpu_torch.inference import prng
from kubeflow_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.llama import llama_test
from kubeflow_tpu_torch.serving import wire

PROMPT_LEN = 8
NEW_TOKENS = 6
CACHE = 32
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


def _config(lane="classic", **kw):
    base = dict(max_new_tokens=NEW_TOKENS, max_prompt_len=PROMPT_LEN,
                temperature=0.8, num_slots=2, page_size=4, slice_tokens=2,
                seed=0, prefix_cache=lane == "prefix")
    base.update(kw)
    return base


def _engine(model, params, name, lane="classic", **kw):
    return DecodeEngine(model, params, EngineConfig(**_config(lane, **kw)),
                        name=name, device="cpu")


def _prompt(seed):
    return np.random.RandomState(seed).randint(0, 512, (PROMPT_LEN,)).astype(
        np.int32)


def test_resume_token_roundtrip_and_validation():
    prompt = np.arange(5, dtype=np.int32)
    keys = np.arange(12, dtype=np.uint32).reshape(6, 2)
    blob = wire.encode_resume_token("m", 3, prompt, keys, 6)
    doc = wire.decode_resume_token(blob, model="m", version=3)
    np.testing.assert_array_equal(doc["prompt_tokens"], prompt)
    np.testing.assert_array_equal(doc["step_keys"], keys)
    assert doc["max_new_tokens"] == 6 and doc["version"] == 3
    with pytest.raises(ValueError, match="model"):
        wire.decode_resume_token(blob, model="other")
    with pytest.raises(ValueError, match="version 3"):
        wire.decode_resume_token(blob, model="m", version=4)
    with pytest.raises(ValueError, match="malformed"):
        wire.decode_resume_token(b"garbage", model="m")
    with pytest.raises(ValueError, match="step_keys shape"):
        wire.decode_resume_token(wire.encode_resume_token(
            "m", 3, prompt, np.zeros((0, 2), np.uint32), 6), model="m")
    # The same bytes the reference writes, read by either package.
    ref = jax_wire.encode_resume_token("m", 3, prompt, keys, 6)
    for doc in (wire.decode_resume_token(ref, model="m"),
                jax_wire.decode_resume_token(blob, model="m")):
        np.testing.assert_array_equal(doc["prompt_tokens"], prompt)
        np.testing.assert_array_equal(doc["step_keys"], keys)


@pytest.mark.parametrize("lane", ["classic", "prefix"])
@pytest.mark.parametrize("temperature", [0.0, 0.8],
                         ids=["greedy", "sampled"])
def test_engine_resume_continuation_bitwise(model, params, lane,
                                            temperature):
    """Kill at any point: the context (prompt and the tokens emitted)
    with the remaining step keys on a PEER engine gives exactly the
    tokens the dead replica would have given."""
    a = _engine(model, params, f"r-a-{lane}{temperature}", lane,
                temperature=temperature)
    b = _engine(model, params, f"r-b-{lane}{temperature}", lane,
                temperature=temperature)
    try:
        prompt = _prompt(3)
        stream = a.submit(prompt, rng=prng.PRNGKey(7))
        full = stream.result(timeout=120)
        ctx = stream.resume_ctx
        assert ctx is not None and len(ctx["step_keys"]) == NEW_TOKENS
        assert ctx["max_new_tokens"] == NEW_TOKENS
        np.testing.assert_array_equal(ctx["prompt"], prompt)
        for kill_at in (1, 3, NEW_TOKENS - 1):
            context = np.concatenate([prompt, full[:kill_at]])
            resumed = b.submit(
                context, step_keys=ctx["step_keys"][kill_at:])
            np.testing.assert_array_equal(resumed.result(timeout=120),
                                          full[kill_at:])
            np.testing.assert_array_equal(resumed.resume_ctx["prompt"],
                                          context)
    finally:
        a.stop()
        b.stop()


def test_engine_resume_validation(model, params):
    eng = _engine(model, params, "r-v")
    try:
        prompt = np.asarray([5, 6, 7], np.int32)
        keys = np.zeros((4, 2), np.uint32)
        with pytest.raises(ValueError, match="mutually exclusive"):
            eng.submit(prompt, step_keys=keys, rng=np.zeros(2, np.uint32))
        with pytest.raises(ValueError, match="resume schedule"):
            eng.submit(prompt, step_keys=keys, max_new_tokens=9)
        # The context bound is cache_size - budget, not max_prompt_len.
        with pytest.raises(ValueError, match="outside"):
            eng.submit(np.arange(CACHE - 4 + 1, dtype=np.int32),
                       step_keys=keys)
        with pytest.raises(ValueError, match="max_new_tokens"):
            eng.submit(prompt, step_keys=np.zeros((NEW_TOKENS + 1, 2),
                                                  np.uint32))
    finally:
        eng.stop()


@pytest.mark.parametrize("lane", ["classic", "prefix"])
def test_engine_resume_context_longer_than_max_prompt(model, params, lane):
    """The context (prompt and emitted) legally exceeds
    ``max_prompt_len``: it is priced and prefilled at its exact width,
    not clamped to a bucket."""
    a = _engine(model, params, f"r-l-{lane}", lane)
    b = _engine(model, params, f"r-l2-{lane}", lane)
    try:
        prompt = _prompt(5)
        stream = a.submit(prompt, rng=prng.PRNGKey(9))
        full = stream.result(timeout=120)
        kill_at = 4  # context = 8 + 4 = 12 > max_prompt_len = 8
        context = np.concatenate([prompt, full[:kill_at]])
        assert len(context) > PROMPT_LEN
        assert b._prompt_width(len(context)) == len(context)
        resumed = b.submit(
            context, step_keys=stream.resume_ctx["step_keys"][kill_at:])
        np.testing.assert_array_equal(resumed.result(timeout=120),
                                      full[kill_at:])
        assert b.stats()["reserved_pages"] == 0
    finally:
        a.stop()
        b.stop()


@pytest.fixture(scope="module")
def pair(model, params, jax_model, jax_params):
    """Per sampling mode: a port engine and a reference engine of one
    classic config."""
    made = {}

    def get(sampling):
        if sampling not in made:
            kw = _config(**(SAMPLED if sampling == "sampled"
                            else dict(temperature=0.0)))
            made[sampling] = (
                DecodeEngine(model, params, EngineConfig(**kw),
                             name=f"rx-port-{sampling}", device="cpu"),
                JaxDecodeEngine(jax_model, jax_params, JaxEngineConfig(**kw),
                                name=f"rx-jax-{sampling}"))
        return made[sampling]

    yield get
    for port, ref in made.values():
        port.stop()
        ref.stop()


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_resume_token_crosses_backends(pair, direction, sampling):
    """The dead replica runs one package; its resume token (written by
    that package's ``wire``) resumes on the other's engine, which
    continues the writer's stream token for token at every kill."""
    port, ref = pair(sampling)
    writer, peer = (ref, port) if direction == "jax_to_port" else (port,
                                                                   ref)
    encode = (jax_wire if writer is ref else wire).encode_resume_token
    decode = (wire if peer is port else jax_wire).decode_resume_token
    prompt = _prompt(21)
    stream = writer.submit(prompt, rng=prng.PRNGKey(33))
    full = stream.result(timeout=180)
    ctx = stream.resume_ctx
    for kill_at in (1, 3, NEW_TOKENS - 1):
        blob = encode("m", 1, np.concatenate([prompt, full[:kill_at]]),
                      ctx["step_keys"][kill_at:], NEW_TOKENS - kill_at)
        doc = decode(blob, model="m", version=1)
        resumed = peer.submit(doc["prompt_tokens"],
                              step_keys=doc["step_keys"])
        np.testing.assert_array_equal(resumed.result(timeout=180),
                                      full[kill_at:])


# -- the split form: submit(prompt_len=) -----------------------------------
#
# The prompt prefilled as its first admission did, the emitted tokens
# replayed on the decode route: on the card only this form gives the
# uninterrupted stream's bits, and on the CPU it must give its tokens in
# every lane, as the reference's whole-context resume does.

#: The lanes a split resume runs in: classic, prefix, and the prefix lane
#: chunked at one page with a strong draft (the model itself, k = 2).
SPLIT_LANES = {"classic": {}, "prefix": {"prefix_cache": True},
               "chunk_spec": {"prefix_cache": True, "prefill_chunk": 4,
                              "speculate_tokens": 2}}


def _lane_engine(model, params, name, lane, sampling):
    kw = _config(**(SAMPLED if sampling == "sampled"
                    else dict(temperature=0.0)))
    kw.update(SPLIT_LANES[lane])
    draft = (dict(draft_model=model, draft_params=params)
             if kw.get("speculate_tokens") else {})
    return DecodeEngine(model, params, EngineConfig(**kw), name=name,
                        device="cpu", **draft)


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
@pytest.mark.parametrize("lane", sorted(SPLIT_LANES))
def test_split_resume_equals_uninterrupted_and_the_reference(
        model, params, pair, lane, sampling):
    """Kills after 1, 3 and budget - 1 tokens: the split resume on a
    peer gives the rest of the uninterrupted stream, and the same tokens
    as the reference engine's resume of the whole context."""
    _, ref = pair(sampling)
    a = _lane_engine(model, params, f"rs-a-{lane}-{sampling}", lane,
                     sampling)
    b = _lane_engine(model, params, f"rs-b-{lane}-{sampling}", lane,
                     sampling)
    try:
        prompt = _prompt(11)
        stream = a.submit(prompt, rng=prng.PRNGKey(13))
        full = stream.result(timeout=180)
        keys = stream.resume_ctx["step_keys"]
        for kill_at in (1, 3, NEW_TOKENS - 1):
            context = np.concatenate([prompt, full[:kill_at]])
            resumed = b.submit(context, step_keys=keys[kill_at:],
                               prompt_len=PROMPT_LEN)
            got = resumed.result(timeout=180)
            np.testing.assert_array_equal(got, full[kill_at:])
            np.testing.assert_array_equal(resumed.resume_ctx["prompt"],
                                          context)
            theirs = ref.submit(context, step_keys=keys[kill_at:])
            np.testing.assert_array_equal(got, theirs.result(timeout=180))
        st = b.stats()
        assert st["reserved_pages"] == 0 and st["active_slots"] == 0
        b.kv.allocator.check_invariants()
    finally:
        a.stop()
        b.stop()


def test_split_resume_validation(model, params):
    eng = _engine(model, params, "rs-v")
    try:
        context = np.arange(10, dtype=np.int32)
        keys = np.zeros((4, 2), np.uint32)
        for bad in (0, 11):
            with pytest.raises(ValueError, match=f"prompt_len {bad} outside"):
                eng.submit(context, step_keys=keys, prompt_len=bad)
        with pytest.raises(ValueError, match="max_prompt_len"):
            eng.submit(context, step_keys=keys, prompt_len=PROMPT_LEN + 1)
        # Bucket 8 for a 5-token prompt, 21 emitted tokens and 6 to go
        # pass the cache's 32 positions, though the 26-token context
        # alone fits beside the budget.
        with pytest.raises(ValueError, match="cache_size"):
            eng.submit(np.arange(26, dtype=np.int32),
                       step_keys=np.zeros((6, 2), np.uint32), prompt_len=5)
        handoff = eng.run_prefill(_prompt(4), rng=prng.PRNGKey(1))
        with pytest.raises(ValueError, match="mutually exclusive"):
            eng.submit(handoff=handoff, prompt_len=3)
        with pytest.raises(ValueError, match="needs step_keys"):
            eng.submit(context[:5], prompt_len=3)
        assert eng.stats()["queue_depth"] == 0
    finally:
        eng.stop()


def test_split_resume_replays_on_the_decode_route(monkeypatch):
    """The route, by the kernel wrappers' calls (llama-test bf16, whose
    projections reach both GEMM wrappers): the resume's one prefill
    runs the prompt's bucket (7 prefill-GEMM calls a layer, 8 rows
    each) and no prefill GEMM sees an emitted token; the emitted tokens
    go through one replay forward on the decode GEMM (7 calls a layer at
    their count of rows) and the decode attention (one query a token a
    layer)."""
    from kubeflow_tpu_torch.models import llama

    bf16 = llama_test(cache_size=CACHE)
    weights = convert.init_params(bf16, seed=0, device="cpu")
    a = _engine(bf16, weights, "rs-route-a", temperature=0.0)
    b = _engine(bf16, weights, "rs-route-b", temperature=0.0)
    calls = {"prefill": [], "decode": [], "attention": []}

    def counted(name, fn, rows):
        def wrapped(*args):
            calls[name].append(rows(args[0]))
            return fn(*args)
        return wrapped

    flat = lambda x: x.reshape(-1, x.shape[-1]).shape[0]  # noqa: E731
    try:
        prompt = _prompt(6)
        stream = a.submit(prompt, rng=prng.PRNGKey(2))
        full = stream.result(timeout=120)
        kill_at = 3
        monkeypatch.setattr(llama, "prefill_linear", counted(
            "prefill", llama.prefill_linear, flat))
        monkeypatch.setattr(llama, "decode_linear", counted(
            "decode", llama.decode_linear, flat))
        monkeypatch.setattr(llama, "decode_attention", counted(
            "attention", llama.decode_attention, lambda q: q.shape[0]))
        resumed = b.submit(np.concatenate([prompt, full[:kill_at]]),
                           step_keys=stream.resume_ctx["step_keys"][kill_at:],
                           prompt_len=PROMPT_LEN)
        np.testing.assert_array_equal(resumed.result(timeout=120),
                                      full[kill_at:])
        layers = bf16.num_layers
        assert calls["prefill"] == [PROMPT_LEN] * 7 * layers
        # The replay's projections at kill_at rows; its head and the
        # prefill's at one row; the decode slices' at the 2 slots.
        assert calls["decode"].count(kill_at) == 7 * layers
        assert set(calls["decode"]) <= {1, kill_at, 2}
        # One query a layer for each emitted token (B = 1), then the
        # decode slices' (B = 2 slots).
        assert calls["attention"].count(1) == kill_at * layers
    finally:
        a.stop()
        b.stop()
