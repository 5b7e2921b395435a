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

"""kubeflow_tpu_torch.training.lm against kubeflow_tpu.training.lm.

``llama-test`` fp32, its params carried across from the reference's
init, the same numpy-seeded batches through both steps: the loss at
each of 5 steps within 1e-5 relative, params and optimizer moments
within 1e-4 after them (fp32 sums in another order than XLA's, grown
by 5 Adam steps, whose update divides by sqrt(nu)). Twins of
tests/test_lm.py's loss-masking case; its gradient-accumulation cases
are in tests/test_torch_lm_accum.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_training import (
    assert_close_to_reference,
    flat,
    ids,
    lm_pair,
)
from kubeflow_tpu.models.llama import llama_test as jax_llama_test
from kubeflow_tpu.training import lm as jlm
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.llama import apply, llama_test
from kubeflow_tpu_torch.training import lm, optim

LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4

TXS = {
    "adamw": (lambda: optax.adamw(1e-3), lambda: optim.adamw(1e-3)),
    # The pretrain CLI's chain (warmup 2 of 10): step 1 at rate 0.
    "pretrain_chain": (
        lambda: optax.chain(
            optax.clip_by_global_norm(1.0),
            optax.adamw(optax.schedules.warmup_cosine_decay_schedule(
                0.0, 1e-3, 2, 10), weight_decay=0.01)),
        lambda: optim.chain(
            optim.clip_by_global_norm(1.0),
            optim.adamw(optim.warmup_cosine_decay_schedule(
                0.0, 1e-3, 2, 10), weight_decay=0.01))),
}


@pytest.mark.parametrize("name", sorted(TXS))
def test_lm_train_step_tracks_the_reference(name):
    make_ref, make_port = TXS[name]
    batches = [{"input_ids": ids(10 + i)} for i in range(5)]
    ref_state, params, model = lm_pair(make_ref())
    ref_step = jlm.make_lm_train_step(None, None, donate=False)
    state, _ = lm.create_lm_state(model, make_port(), params)
    step = lm.make_lm_train_step()
    for i, batch in enumerate(batches):
        ref_state, ref_m = ref_step(ref_state, batch)
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=1e-4)
        assert float(m["aux_loss"]) == float(ref_m["aux_loss"]) == 0.0
    assert state.step == int(ref_state.step) == 5
    assert_close_to_reference(state, ref_state,
                              ("step", "params", "opt_state"), PARAM_TOL)


def test_loss_masking():
    """Twin of tests/test_lm.py::test_loss_masking."""
    logits = torch.zeros((2, 4, 8))
    batch = {"mlm_labels": torch.zeros((2, 4), dtype=torch.int32),
             "mlm_weights": torch.zeros((2, 4), dtype=torch.int32)}
    loss, acc = lm.mlm_loss(logits, batch)
    assert float(loss) == 0.0  # fully masked → zero, not NaN
    ids_ = torch.tensor([[1, 2, 3, 4]])
    loss, _ = lm.causal_lm_loss(torch.zeros((1, 4, 8)),
                                {"input_ids": ids_})
    np.testing.assert_allclose(float(loss), np.log(8), rtol=1e-5)


@pytest.mark.parametrize("case", ["plain", "preshifted", "loss_weights",
                                  "preshifted_weights", "mlm"])
def test_batch_conventions_match_the_reference(case):
    """lm_targets, the losses and lm_token_weight under each batch
    convention, on the same logits and batch as the reference's."""
    rng = np.random.default_rng(1)
    b, l, v = 3, 7, 11
    x = rng.integers(0, v, (b, l)).astype(np.int32)
    batch = {"input_ids": x}
    if case.startswith("preshifted"):
        batch = {"input_ids": x[:, :-1], "targets": x[:, 1:]}
    if case.endswith("weights"):
        w = (rng.random(batch["input_ids"].shape) < 0.6).astype(np.float32)
        batch["loss_weights"] = w
    objective = "causal"
    if case == "mlm":
        objective = "mlm"
        batch["mlm_labels"] = rng.integers(0, v, (b, l)).astype(np.int32)
        batch["mlm_weights"] = (rng.random((b, l)) < 0.3).astype(np.int32)
    logits = rng.standard_normal(
        (b, batch["input_ids"].shape[1], v)).astype(np.float32)
    ref_loss, ref_acc = jlm.LOSSES[objective](
        jnp.asarray(logits), {k: jnp.asarray(a) for k, a in batch.items()})
    t_batch = {k: torch.from_numpy(a) for k, a in batch.items()}
    loss, acc = lm.LOSSES[objective](torch.from_numpy(logits), t_batch)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    np.testing.assert_allclose(float(acc), float(ref_acc), atol=1e-7)
    np.testing.assert_allclose(
        float(lm.lm_token_weight(t_batch, objective)),
        float(jlm.lm_token_weight(
            {k: jnp.asarray(a) for k, a in batch.items()}, objective)))


def test_fp32_masters_with_bf16_compute_match_the_reference():
    """Training storage: fp32 params cast to bf16 at each op, as Flax
    does (and the lm_head kept fp32)."""
    ref_state, _, _ = lm_pair(optax.adamw(1e-3))
    x = ids(7, b=2, l=32)
    ref = jax.jit(jax_llama_test().apply)({"params": ref_state.params},
                                          jnp.asarray(x))
    model = llama_test(param_dtype="float32")
    params = convert.params_from_flax(flat(ref_state.params), model,
                                      device="cpu")
    assert all(p.dtype == torch.float32 for p in params.values())
    out = apply(model, params, torch.from_numpy(x))
    assert out.dtype == torch.float32
    # bf16 activations through two layers (the reference's bound for a
    # bf16 Llama, PERF.md §2).
    err = (np.linalg.norm(out.detach().numpy() - np.asarray(ref))
           / np.linalg.norm(np.asarray(ref)))
    assert err < 3e-2, err


def test_remat_gives_the_same_gradients():
    """Rematerialised blocks recompute the same ops: the same loss and
    gradients (the same bits on the CPU)."""
    _, params, _ = lm_pair(optax.sgd(0.1))
    batch = {"input_ids": torch.from_numpy(ids(2, b=2, l=32))}
    grads = []
    for remat in (False, True):
        model = llama_test(dtype="float32", remat=remat)
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        loss, _ = lm.causal_lm_loss(apply(model, p, batch["input_ids"]),
                                    batch)
        grads.append(torch.autograd.grad(loss, list(p.values())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_mesh_and_bert_batches_raise_with_their_roadmap_items():
    """The mesh still raises (ROADMAP A14). A BERT batch (the mlm
    objective's) on a Llama runs as the reference runs it: its type_ids
    are the Llama's positions, its valid mask the ignored train flag
    (BERT itself: tests/test_torch_bert.py; MoE:
    tests/test_torch_moe.py)."""
    ref_state, params, model = lm_pair(optax.sgd(0.1))
    with pytest.raises(NotImplementedError, match="A14"):
        lm.create_lm_state(model, optim.sgd(0.1), params, mesh=object())
    with pytest.raises(NotImplementedError, match="A14"):
        lm.make_lm_train_step(object())
    state, _ = lm.create_lm_state(model, optim.sgd(0.1), params)
    rng = np.random.default_rng(5)
    bert = {"input_ids": ids(0),
            "type_ids": rng.integers(0, 2, (4, 32)).astype(np.int32),
            "valid": np.ones((4, 32), np.int32),
            "mlm_labels": ids(1),
            "mlm_weights": (rng.random((4, 32)) < 0.15).astype(np.int32)}
    ref_step = jlm.make_lm_train_step(None, None, objective="mlm",
                                      donate=False)
    _, ref_m = ref_step(ref_state, bert)
    _, m = lm.make_lm_train_step(objective="mlm")(state, bert)
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=LOSS_RTOL)
    assert llama_test(num_experts=4).num_experts == 4
