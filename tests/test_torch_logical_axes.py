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

"""Every registered model's ``logical_axes`` against the reference's
``nn.with_partitioning`` names.

For each model of the registry (and its LoRA adapters, for the Llama
family), leaf for leaf: the port's ``logical_axes(key)`` of each Flax
key is ``nn.get_partition_spec(jax.eval_shape(init))`` of the
reference (None for an unannotated leaf), and ``partitioned(key)`` is
whether it has any. The init is abstract (eval_shape), so the full
configs cost no memory.
"""

import jax
import jax.numpy as jnp
import pytest
from flax import linen as nn
from flax.traverse_util import flatten_dict

from kubeflow_tpu.models.registry import list_models as jax_models
from kubeflow_tpu_torch.models.registry import list_models


def _reference_axes(name, kw):
    entry = jax_models()[name]
    model = entry.make(**kw)
    shape, dtype = entry.input_spec
    x = jnp.zeros((1,) + tuple(shape), dtype)
    train = {"train": False} if entry.family == "vision" else {}
    variables = jax.eval_shape(lambda r: model.init(r, x, **train),
                               jax.random.PRNGKey(0))
    spec = nn.get_partition_spec({k: variables[k] for k in variables
                                  if k in ("params", "lora")})
    out = {}
    for key, leaf in flatten_dict(
            spec, sep="/", is_leaf=lambda k, v: not isinstance(v, dict)
    ).items():
        out[key] = tuple(leaf) if leaf is not None and len(leaf) else None
    return out


CASES = [(name, {}) for name in sorted(list_models())] + [
    (name, {"lora_rank": 4}) for name in ("llama-test", "llama3-8b")]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}{'-lora' if kw else ''}"
                              for n, kw in CASES])
def test_logical_axes_are_the_references(name, kw):
    assert name in jax_models()
    want = _reference_axes(name, kw)
    port = list_models()[name].make(**kw)
    assert want, name
    for key, axes in want.items():
        inner = key.split("/", 1)[1]
        assert port.logical_axes(inner) == axes, key
        assert port.logical_axes(key) == axes, key
        if key.startswith("params/"):
            assert port.partitioned(inner) == (axes is not None), key
