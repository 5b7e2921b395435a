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

"""kubeflow_tpu_torch's Llama vs kubeflow_tpu's, on ``llama-test`` fp32.

The Flax params are carried across with ``params_from_flax``; the same
numpy-seeded token ids go through both. Tolerance 1e-4 on the logits:
two fp32 layers, a 512-wide fp32 head and fp32 trig, with sums taken in
another order (and pow/sin/cos from another math library) than XLA's —
differences of a few fp32 ulps that the matrix products amplify.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from kubeflow_tpu.inference.generate import init_cache as jax_init_cache
from kubeflow_tpu.models.llama import llama_test as jax_llama_test
from kubeflow_tpu_torch.inference.generate import init_cache
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.llama import apply, llama_test, rope
from kubeflow_tpu_torch.models.registry import get_model

TOL = dict(atol=1e-4, rtol=1e-4)
CACHE = 24


@pytest.fixture(scope="module")
def flax_params():
    model = jax_llama_test(dtype=jnp.float32)
    ids = jnp.zeros((1, 8), jnp.int32)
    variables = model.init(jax.random.PRNGKey(0), ids)
    return nn.meta.unbox(variables["params"])


def _port_params(flax_params, model):
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(flax_params, sep="/").items()}
    return convert.params_from_flax(flat, model, device="cpu")


def _ids(seed, b, l):
    return np.random.default_rng(seed).integers(0, 512, (b, l)).astype(
        np.int32)


def test_no_cache_forward(flax_params):
    ids = _ids(0, 2, 32)
    ref = jax_llama_test(dtype=jnp.float32).apply(
        {"params": flax_params}, jnp.asarray(ids))
    model = llama_test(dtype="float32")
    out = apply(model, _port_params(flax_params, model),
                torch.from_numpy(ids))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("pad", [None, [3, 0]])
def test_prefill_and_decode_step(flax_params, pad):
    b, l = 2, 10
    ids = _ids(1, b, l)
    jax_model = jax_llama_test(dtype=jnp.float32, cache_size=CACHE)
    model = llama_test(dtype="float32", cache_size=CACHE)
    params = _port_params(flax_params, model)
    if pad is None:
        positions = np.broadcast_to(np.arange(l), (b, l)).astype(np.int32)
        jkw, tkw = {}, {}
    else:
        pad_np = np.asarray(pad, np.int32)
        positions = np.maximum(np.arange(l)[None] - pad_np[:, None],
                               0).astype(np.int32)
        jkw = {"pad_lengths": jnp.asarray(pad_np)}
        tkw = {"pad_lengths": torch.from_numpy(pad_np)}

    cache = jax_init_cache(jax_model, flax_params, b)
    ref, mutated = jax_model.apply(
        {"params": flax_params, "cache": cache}, jnp.asarray(ids),
        jnp.asarray(positions), mutable=["cache"], **jkw)
    tcache = init_cache(model, params, b)
    out = apply(model, params, torch.from_numpy(ids),
                torch.from_numpy(positions), cache=tcache, **tkw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert all(c.index == l for c in tcache)

    # One decode step at each row's next position.
    nxt = _ids(2, b, 1)
    pos = positions[:, -1:] + 1
    ref2, _ = jax_model.apply(
        {"params": flax_params, "cache": mutated["cache"]},
        jnp.asarray(nxt), jnp.asarray(pos), mutable=["cache"], **jkw)
    out2 = apply(model, params, torch.from_numpy(nxt), torch.from_numpy(pos),
                 cache=tcache, **tkw)
    np.testing.assert_allclose(out2.numpy(), np.asarray(ref2), **TOL)


def test_rope_interleaved_pairs():
    from kubeflow_tpu.models.llama import rope as jax_rope

    x = np.random.default_rng(3).standard_normal((2, 5, 3, 8)).astype(
        np.float32)
    pos = np.arange(10, dtype=np.int32).reshape(2, 5)
    ref = jax_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    out = rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["llama-test", "llama2-7b", "llama2-13b",
                                  "llama3-8b"])
def test_registered_configs_match_reference(name):
    from kubeflow_tpu.models.registry import get_model as jax_get_model

    jax_model = jax_get_model(name).make()
    model = get_model(name).make()
    for field in ("vocab_size", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "mlp_dim", "rope_theta"):
        assert getattr(model, field) == getattr(jax_model, field), field
    assert get_model(name).input_spec == jax_get_model(name).input_spec
    # Built on the meta device: an 8B template costs no memory.
    assert all(p.is_meta for p in model.parameters())


def test_params_from_flax_rejects_missing_and_extra_keys(flax_params):
    model = llama_test(dtype="float32")
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(flax_params, sep="/").items()}
    with pytest.raises(ValueError, match="no place"):
        convert.params_from_flax({**flat, "layer_0/lora_a": flat[
            "final_norm/scale"]}, model, device="cpu")
    flat.pop("lm_head/kernel")
    with pytest.raises(KeyError, match="lm_head/kernel"):
        convert.params_from_flax(flat, model, device="cpu")


def test_bf16_model_stores_bf16_weights_and_fp32_head():
    model = llama_test()
    params = convert.init_params(model, seed=0, device="cpu")
    assert params["lm_head.weight"].dtype == torch.float32
    assert params["layers.0.attention.q_proj.weight"].dtype == torch.bfloat16
    assert torch.all(params["final_norm.scale"] == 1)
    again = convert.init_params(model, seed=0, device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        llama_test(num_experts=4)
    # LoRA is ported (tests/test_torch_lora.py); a negative rank raises.
    assert llama_test(lora_rank=8).layers[0].attention.q_proj.rank == 8
    with pytest.raises(ValueError, match="lora_rank"):
        llama_test(lora_rank=-1)
    model = llama_test(dtype="float32")
    params = convert.init_params(model, seed=0, device="cpu")
    ids = torch.zeros((1, 4), dtype=torch.int32)
    # decode_positions needs a cache model; there the multi-token
    # verify of speculative decoding runs (tests/test_torch_spec_decode.py
    # holds it against the reference's).
    with pytest.raises(ValueError, match="decode_positions"):
        apply(model, params, ids, decode_positions=torch.zeros(1))
    cache_model = llama_test(dtype="float32", cache_size=8)
    cache = init_cache(cache_model, params, 1)
    with torch.inference_mode():
        logits = apply(cache_model, params, ids, ids.long(), cache=cache,
                       decode_positions=torch.zeros(1, dtype=torch.int32))
    assert logits.shape == (1, 4, 512) and torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="pad_lengths"):
        apply(model, params, ids, pad_lengths=torch.zeros(1))
