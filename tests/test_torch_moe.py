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

"""kubeflow_tpu_torch.ops.moe and the MoE Llama against the reference.

Tolerances: ``compute_capacity`` and ``top_k_dispatch``'s combine and
fraction exactly equal on the same fp32 probabilities (the routing is
argmax, cumsum and one-hot products of exact values); the ``MoE`` layer
1e-5 fp32 (its products summed in another order than XLA's) and its
aux loss 1e-6; ``llama-moe-test`` logits 1e-4 fp32 with greedy tokens
equal; the tpu-lm step with the aux loss 1e-5 relative a step over 5.
Twins of tests/test_moe.py and tests/test_lora.py's MoE case.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_training import flat, ids, lm_pair, lora_pair
from kubeflow_tpu.inference.generate import generate as jax_generate
from kubeflow_tpu.ops import moe as jmoe
from kubeflow_tpu.training import finetune as jft
from kubeflow_tpu.training import lm as jlm
from kubeflow_tpu_torch.inference.generate import generate
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.llama import apply, llama_moe_test
from kubeflow_tpu_torch.ops import moe
from kubeflow_tpu_torch.training import finetune, lm, optim

LAYER_TOL = 1e-5
AUX_TOL = 1e-6
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5


@pytest.mark.parametrize("tokens,experts,k,factor", [
    (8, 4, 1, 1.0), (16, 4, 2, 1.25), (1024, 8, 2, 1.25), (3, 8, 2, 0.5),
    (512, 8, 2, 1.25)])
def test_compute_capacity_equals_the_reference(tokens, experts, k, factor):
    assert moe.compute_capacity(tokens, experts, k, factor) == (
        jmoe.compute_capacity(tokens, experts, k, factor))


def _probs(case):
    if case == "drops_top1":
        # Every token prefers expert 0: past 4 slots they are dropped.
        return np.tile(np.array([[0.97, 0.01, 0.01, 0.01]], np.float32),
                       (32, 1))
    t, e = {"ample_top1": (16, 4), "ample_top2": (8, 4),
            "drops_top2": (48, 4), "ties": (12, 4)}[case]
    logits = np.random.default_rng(len(case)).standard_normal((t, e))
    if case == "ties":
        logits[:, 1] = logits[:, 2]  # argmax ties take the first
    return np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1))


@pytest.mark.parametrize("case,k,capacity", [
    ("ample_top1", 1, 16), ("ample_top2", 2, 8), ("drops_top1", 1, 4),
    ("drops_top2", 2, 8), ("ties", 2, 4)])
def test_top_k_dispatch_equals_the_reference(case, k, capacity):
    probs = _probs(case)
    ref_combine, ref_fraction = jmoe.top_k_dispatch(jnp.asarray(probs), k,
                                                    capacity)
    combine, fraction = moe.top_k_dispatch(torch.from_numpy(probs), k,
                                           capacity)
    np.testing.assert_array_equal(combine.numpy(), np.asarray(ref_combine))
    np.testing.assert_array_equal(fraction.numpy(), np.asarray(ref_fraction))


def test_fit_group_size_equals_the_reference():
    for tokens, group in ((16384, 512), (100, 512), (96, 64), (7, 4)):
        assert moe._fit_group_size(tokens, group) == jmoe._fit_group_size(
            tokens, group)


def _moe_pair(k, group_size=512, factor=1.25):
    ref = jmoe.MoE(num_experts=4, mlp_dim=32, num_selected=k,
                   capacity_factor=factor, group_size=group_size,
                   dtype=jnp.float32)
    x = np.random.default_rng(k).standard_normal((2, 24, 16)).astype(
        np.float32)
    variables = nn.meta.unbox(ref.init(jax.random.PRNGKey(3), x))
    port = moe.MoE(16, 4, 32, k, factor, group_size, dtype=torch.float32,
                   device="cpu")
    params = convert.params_from_flax(flat(variables["params"]), port,
                                      device="cpu")
    return ref, {"params": variables["params"]}, port, params, x


@pytest.mark.parametrize("k,group_size", [(1, 512), (2, 512), (2, 16)])
def test_moe_layer_and_aux_loss_match_the_reference(k, group_size):
    ref, variables, port, params, x = _moe_pair(k, group_size)
    out, state = ref.apply(variables, x, mutable=["losses"])
    with moe.collect_losses() as sown:
        got = torch.func.functional_call(port, params,
                                         (torch.from_numpy(x),))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=LAYER_TOL,
                               rtol=LAYER_TOL)
    (aux,) = state["losses"]["moe_aux"]
    assert len(sown) == 1
    np.testing.assert_allclose(float(sown[0]), float(aux), atol=AUX_TOL,
                               rtol=AUX_TOL)


def test_sow_outside_a_collector_is_dropped_and_top1_router_learns():
    _, _, port, params, x = _moe_pair(1)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    out = torch.func.functional_call(port, params, (torch.from_numpy(x),))
    (grad,) = torch.autograd.grad(out.square().sum(),
                                  [params["router.weight"]])
    assert float(grad.abs().sum()) > 0  # the raw top-1 gate, not 1.0


def _moe_llama_pair():
    ref, params, model = lm_pair(optax.sgd(0.1), num_experts=4)
    return ref, params, model


def test_llama_moe_logits_and_greedy_tokens_match_the_reference():
    ref_state, params, model = _moe_llama_pair()
    x = ids(3, b=2, l=16)
    ref_logits = ref_state.apply_fn({"params": ref_state.params}, x)
    logits = apply(model, params, torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    from kubeflow_tpu.models.llama import llama_moe_test as jax_moe_test

    cached = jax_moe_test(dtype=jnp.float32, cache_size=24)
    ref_tok, _ = jax_generate(cached, ref_state.params, jnp.asarray(x[:, :8]),
                              max_new_tokens=6)
    port_cached = llama_moe_test(dtype="float32", cache_size=24)
    tok, _ = generate(port_cached, params, torch.from_numpy(x[:, :8]),
                      max_new_tokens=6)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))


def test_moe_lm_step_with_the_aux_loss_tracks_the_reference():
    ref_state, params, model = lm_pair(optax.adamw(1e-3), num_experts=4)
    ref_step = jlm.make_lm_train_step(None, None, donate=False)
    state, _ = lm.create_lm_state(model, optim.adamw(1e-3), params)
    step = lm.make_lm_train_step()
    for i in range(5):
        batch = {"input_ids": ids(20 + i)}
        ref_state, ref_m = ref_step(ref_state, batch)
        state, m = step(state, batch)
        for key in ("loss", "aux_loss"):
            np.testing.assert_allclose(float(m[key]), float(ref_m[key]),
                                       rtol=LOSS_RTOL,
                                       err_msg=f"{key} step {i}")
        assert float(m["aux_loss"]) > 0


def test_lora_over_moe_collects_the_aux_loss():
    ref_state, base, lora, model = lora_pair(optax.adamw(1e-2),
                                             num_experts=4)
    ref_step = jft.make_lora_train_step(None, None, donate=False)
    state, _ = finetune.create_lora_state(model, optim.adamw(1e-2), base,
                                          lora=lora)
    step = finetune.make_lora_train_step()
    batch = {"input_ids": ids(7)}
    _, ref_m = ref_step(ref_state, batch)
    _, m = step(state, batch)
    assert float(m["aux_loss"]) > 0.0
    np.testing.assert_allclose(float(m["aux_loss"]), float(ref_m["aux_loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=LOSS_RTOL)
