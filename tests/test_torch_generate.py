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

"""Greedy generation in kubeflow_tpu_torch vs kubeflow_tpu.

``llama-test`` in fp32 with the reference's params carried across:
greedy tokens must be identical, logits within 1e-4 (the Llama parity
tolerance, tests/test_torch_llama.py). Inside the port, the chunked loop
and the batched mixed-length decode must equal the monolithic and B=1
runs exactly.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from kubeflow_tpu.inference.generate import generate as jax_generate
from kubeflow_tpu.models.llama import llama_test as jax_llama_test
from kubeflow_tpu_torch.inference.generate import generate, prompt_bucket
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


def test_sampling_raises_until_threefry_is_ported(models):
    _, _, model, params = models
    ids = torch.from_numpy(_prompts(6, 1, 4))
    with pytest.raises(NotImplementedError, match="threefry"):
        generate(model, params, ids, max_new_tokens=2, temperature=0.7)


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
