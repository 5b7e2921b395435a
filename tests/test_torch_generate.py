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

"""Generation in kubeflow_tpu_torch vs kubeflow_tpu, greedy and sampled.

``llama-test`` in fp32 with the reference's params carried across:
greedy and sampled tokens must be identical (the same threefry keys;
the Gumbel noise agrees to ~1e-6, which flips only a near-tie), logits
within 1e-4 (the Llama parity tolerance, tests/test_torch_llama.py).
``_truncate_logits`` must mask the same logits as the reference's.
Inside the port, the chunked loop and the batched mixed-length decode
must equal the monolithic and B=1 runs exactly, greedy and sampled.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from kubeflow_tpu.inference.generate import _truncate_logits as jax_truncate
from kubeflow_tpu.inference.generate import generate as jax_generate
from kubeflow_tpu.models.llama import llama_test as jax_llama_test
from kubeflow_tpu_torch.inference import prng
from kubeflow_tpu_torch.inference.generate import (
    _truncate_logits,
    generate,
    prompt_bucket,
)
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.llama import llama_test

CACHE = 32
NEW = 6


@pytest.fixture(scope="module")
def models():
    jax_model = jax_llama_test(dtype=jnp.float32, cache_size=CACHE)
    variables = jax_model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 8), jnp.int32))
    flax_params = nn.meta.unbox(variables["params"])
    model = llama_test(dtype="float32", cache_size=CACHE)
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(flax_params, sep="/").items()}
    params = convert.params_from_flax(flat, model, device="cpu")
    return jax_model, flax_params, model, params


def _prompts(seed, b, l):
    return np.random.default_rng(seed).integers(1, 512, (b, l)).astype(
        np.int32)


@pytest.mark.parametrize("lengths", [None, [5, 12]])
def test_greedy_tokens_match_reference(models, lengths):
    jax_model, flax_params, model, params = models
    ids = _prompts(0, 2, 12)
    kw = {} if lengths is None else {"prompt_lengths": np.asarray(lengths)}
    ref_tok, ref_log = jax_generate(jax_model, flax_params, jnp.asarray(ids),
                                    max_new_tokens=NEW, **kw)
    tok, log = generate(model, params, torch.from_numpy(ids),
                        max_new_tokens=NEW,
                        **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_allclose(log.numpy(), np.asarray(ref_log), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_chunked_equals_monolithic(models, chunk):
    _, _, model, params = models
    ids = torch.from_numpy(_prompts(1, 2, 8))
    lengths = torch.tensor([3, 8])
    mono, mono_log = generate(model, params, ids, max_new_tokens=NEW,
                              prompt_lengths=lengths)
    tok, log = generate(model, params, ids, max_new_tokens=NEW,
                        chunk_tokens=chunk, prompt_lengths=lengths)
    assert torch.equal(tok, mono)
    assert torch.equal(log, mono_log)


def test_batched_mixed_length_equals_b1(models):
    _, _, model, params = models
    rows = [_prompts(2, 1, 4)[0], _prompts(3, 1, 9)[0]]
    width = 9
    padded = np.zeros((2, width), np.int32)
    for i, r in enumerate(rows):
        padded[i, width - len(r):] = r
    batch, _ = generate(model, params, torch.from_numpy(padded),
                        max_new_tokens=NEW,
                        prompt_lengths=torch.tensor([4, 9]))
    for i, r in enumerate(rows):
        alone, _ = generate(model, params, torch.from_numpy(r[None]),
                            max_new_tokens=NEW)
        assert torch.equal(batch[i], alone[0])


def test_eos_latches(models):
    jax_model, flax_params, model, params = models
    ids = _prompts(4, 2, 8)
    free, _ = generate(model, params, torch.from_numpy(ids),
                       max_new_tokens=NEW)
    eos = int(free[0, 1])
    tok, _ = generate(model, params, torch.from_numpy(ids),
                      max_new_tokens=NEW, eos_id=eos)
    first = int(np.argmax(tok[0].numpy() == eos))
    assert first <= 1 and torch.all(tok[0, first:] == eos)
    ref, _ = jax_generate(jax_model, flax_params, jnp.asarray(ids),
                          max_new_tokens=NEW, eos_id=eos)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref))


def test_validation_errors(models):
    _, _, model, params = models
    ids = torch.from_numpy(_prompts(5, 2, 8))
    with pytest.raises(ValueError, match="cache_size"):
        generate(model, params, ids, max_new_tokens=CACHE)
    with pytest.raises(ValueError, match="prompt_lengths shape"):
        generate(model, params, ids, max_new_tokens=2,
                 prompt_lengths=torch.tensor([8]))
    with pytest.raises(ValueError, match="prompt_lengths must be in"):
        generate(model, params, ids, max_new_tokens=2,
                 prompt_lengths=torch.tensor([0, 8]))
    with pytest.raises(ValueError, match="prompt_lengths must be in"):
        generate(model, params, ids, max_new_tokens=2,
                 prompt_lengths=torch.tensor([9, 8]))
    with pytest.raises(ValueError, match="chunk_tokens"):
        generate(model, params, ids, max_new_tokens=2, chunk_tokens=0)


SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.9), (10, 0.8),
                                         (None, 0.0), (0, 1.0), (600, None)])
def test_truncate_logits_matches_reference(top_k, top_p):
    x = (np.random.default_rng(1).standard_normal((4, 512)) * 3).astype(
        np.float32)
    want = np.asarray(jax_truncate(jnp.asarray(x), top_k, top_p))
    got = _truncate_logits(torch.from_numpy(x), top_k, top_p).numpy()
    np.testing.assert_array_equal(got, want)
    if top_p == 0.0:
        # Greedy, not an all -inf row (categorical would emit token 0).
        assert (np.isfinite(got).sum(-1) == 1).all()
        np.testing.assert_array_equal(np.isfinite(got).argmax(-1),
                                      x.argmax(-1))


@pytest.mark.parametrize("sampling", [
    SAMPLING, dict(temperature=1.0), dict(temperature=0.7, top_p=0.5)],
    ids=["topk-topp", "plain", "topp"])
@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per-row"])
def test_sampled_tokens_match_reference(models, sampling, per_row):
    jax_model, flax_params, model, params = models
    ids = _prompts(7, 3, 12)
    lengths = np.asarray([5, 12, 9])
    key = jax.random.PRNGKey(7)
    rng = jax.random.split(key, 3) if per_row else key
    ref, _ = jax_generate(jax_model, flax_params, jnp.asarray(ids),
                          max_new_tokens=NEW, rng=rng,
                          prompt_lengths=jnp.asarray(lengths), **sampling)
    tok, _ = generate(model, params, torch.from_numpy(ids),
                      max_new_tokens=NEW, rng=np.asarray(rng),
                      prompt_lengths=torch.from_numpy(lengths), **sampling)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref))


def test_sampled_default_key_is_prng_key_0(models):
    jax_model, flax_params, model, params = models
    ids = _prompts(8, 2, 8)
    ref, _ = jax_generate(jax_model, flax_params, jnp.asarray(ids),
                          max_new_tokens=NEW, **SAMPLING)
    tok, _ = generate(model, params, torch.from_numpy(ids),
                      max_new_tokens=NEW, **SAMPLING)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref))


def test_sampled_batch_rows_equal_b1(models):
    _, _, model, params = models
    rows = [_prompts(2, 1, 4)[0], _prompts(3, 1, 9)[0], _prompts(4, 1, 7)[0]]
    keys = np.stack([prng.PRNGKey(10 + i) for i in range(3)])
    width = 9
    padded = np.zeros((3, width), np.int32)
    for i, r in enumerate(rows):
        padded[i, width - len(r):] = r
    batch, _ = generate(model, params, torch.from_numpy(padded),
                        max_new_tokens=NEW, rng=keys,
                        prompt_lengths=torch.tensor([4, 9, 7]), **SAMPLING)
    for i, r in enumerate(rows):
        alone, _ = generate(model, params, torch.from_numpy(r[None]),
                            max_new_tokens=NEW, rng=keys[i:i + 1],
                            **SAMPLING)
        assert torch.equal(batch[i], alone[0])


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_sampled_chunked_equals_monolithic(models, chunk):
    _, _, model, params = models
    ids = torch.from_numpy(_prompts(1, 2, 8))
    lengths = torch.tensor([3, 8])
    kw = dict(max_new_tokens=NEW, prompt_lengths=lengths,
              rng=prng.PRNGKey(5), **SAMPLING)
    mono, mono_log = generate(model, params, ids, **kw)
    tok, log = generate(model, params, ids, chunk_tokens=chunk, **kw)
    assert torch.equal(tok, mono)
    assert torch.equal(log, mono_log)


@pytest.mark.parametrize("n,max_len,buckets", [
    (1, 64, None), (5, 64, None), (64, 64, None), (70, 64, None),
    (5, 64, [4, 16, 48]), (20, 64, [4, 16, 48]), (60, 64, [4, 16, 48]),
])
def test_prompt_bucket_matches_reference(n, max_len, buckets):
    from kubeflow_tpu.inference.generate import (
        prompt_bucket as jax_prompt_bucket,
    )

    assert prompt_bucket(n, max_len, buckets) == jax_prompt_bucket(
        n, max_len, buckets)
