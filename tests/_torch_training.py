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

"""Shared helpers of the port's LM-training tests (not a test module).

The reference's train states are built as its own tests build them
(``create_lm_state`` / ``create_lora_state`` on ``llama-test``) and
carried across to the port (``models/convert.py``), so both trainers
start from the same params and see the same numpy-seeded batches.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
from flax.traverse_util import flatten_dict

from kubeflow_tpu.models.llama import llama_test as jax_llama_test
from kubeflow_tpu.models.registry import get_model as jax_get_model
from kubeflow_tpu.training.checkpoint import flatten_state as jax_flatten
from kubeflow_tpu.training.finetune import LoRAState
from kubeflow_tpu.training.lm import LMState
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.llama import llama_test
from kubeflow_tpu_torch.models.registry import get_model as port_get_model

VOCAB = 512


def ids(seed, b=4, l=32):
    return np.random.default_rng(seed).integers(
        0, VOCAB, (b, l)).astype(np.int32)


def flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


@functools.lru_cache(maxsize=None)
def _jax_init(seed, kw):
    """The reference's ``llama-test`` fp32 variables from ``seed``, as
    its ``create_lm_state`` / ``create_lora_state`` draw them (the init
    jitted once: eagerly it takes ~10 s on the CPU)."""
    model = jax_llama_test(dtype=jnp.float32, **dict(kw))
    init = jax.jit(lambda r: model.init(r, jnp.zeros((1, 8), jnp.int32)))
    return nn.meta.unbox(init(jax.random.PRNGKey(seed)))


def lm_pair(ref_tx, seed=1, **kw):
    """(reference LMState, port params, port model) from one init: the
    state ``create_lm_state`` builds without a mesh."""
    jmodel = jax_llama_test(dtype=jnp.float32, **kw)
    params = _jax_init(seed, tuple(sorted(kw.items())))["params"]
    state = LMState(step=jnp.zeros((), jnp.int32), params=params,
                    opt_state=ref_tx.init(params), apply_fn=jmodel.apply,
                    tx=ref_tx)
    model = llama_test(dtype="float32", **kw)
    params = convert.params_from_flax(flat(state.params), model,
                                      device="cpu")
    return state, params, model


def lora_pair(ref_tx, rank=4, seed=1, **kw):
    """(reference LoRAState, port base, port adapters, port model): the
    state ``create_lora_state`` builds without a mesh."""
    jmodel = jax_llama_test(dtype=jnp.float32, lora_rank=rank, **kw)
    variables = _jax_init(seed, tuple(sorted(dict(kw, lora_rank=rank)
                                             .items())))
    state = LoRAState(step=jnp.zeros((), jnp.int32),
                      base_params=variables["params"],
                      lora=variables["lora"],
                      opt_state=ref_tx.init(variables["lora"]),
                      apply_fn=jmodel.apply, tx=ref_tx)
    model = llama_test(dtype="float32", lora_rank=rank, **kw)
    base = convert.params_from_flax(flat(state.base_params), model,
                                    device="cpu")
    lora = convert.lora_from_flax(flat(state.lora), model, device="cpu")
    return state, base, lora, model


def reference_flat_state(state, fields):
    """The reference's checkpoint keys and host values of ``fields``."""
    out, _ = jax_flatten({f: getattr(state, f) for f in fields})
    return {k: np.asarray(v) for k, v in out.items()}


def assert_close_to_reference(port_state, ref_state, fields, tol):
    """Every leaf of ``fields`` of both states, by the reference's
    checkpoint keys, within ``tol`` (atol and rtol)."""
    ref = reference_flat_state(ref_state, fields)
    port = convert.state_to_flax(port_state)
    port = {k: v for k, v in port.items() if k.split("/")[0] in fields}
    assert set(port) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(np.asarray(port[k], np.float64),
                                   np.asarray(v, np.float64), rtol=tol,
                                   atol=tol, err_msg=k)


@functools.lru_cache(maxsize=None)
def _registry_init(name, seed, shapes, kw):
    model = jax_get_model(name).make(**dict(kw))
    args = [None if s is None else jnp.zeros(s, dt) for s, dt in shapes]
    train = {} if jax_get_model(name).family == "language" else {
        "train": False}
    init = jax.jit(lambda r: model.init(r, *args, **train))
    return nn.meta.unbox(init(jax.random.PRNGKey(seed)))


def reference_variables(name, shapes, seed=0, **kw):
    """``(reference module, its variables)`` for registry model ``name``
    built with ``kw``, initialised from ``seed`` over zero inputs of
    ``shapes`` (``[(shape, dtype) or (None, None), ...]``, the positional
    inputs), the init jitted once and cached. Only ``params`` and
    ``batch_stats`` are kept (an init's sown losses are not state)."""
    variables = _registry_init(name, seed, tuple(shapes),
                               tuple(sorted(kw.items())))
    keep = {k: v for k, v in variables.items()
            if k in ("params", "batch_stats")}
    return jax_get_model(name).make(**kw), keep


def port_variables(name, variables, **kw):
    """``(port module, params, batch_stats)`` for registry model
    ``name`` built with ``kw``, the reference's variables carried
    across on the CPU."""
    model = port_get_model(name).make(**kw)
    params = convert.params_from_flax(flat(variables["params"]), model,
                                      device="cpu")
    stats = convert.batch_stats_from_flax(
        flat(variables.get("batch_stats", {})), model, device="cpu") if (
        "batch_stats" in variables) else {}
    return model, params, stats
