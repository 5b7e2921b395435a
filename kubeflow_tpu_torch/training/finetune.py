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


"""Parameter-efficient fine-tuning: a frozen base and trainable LoRA.

The port of ``kubeflow_tpu/training/finetune.py``, on one device or on
a gang's mesh over the batch axes (``training/lm.py`` has the recipe:
the base and the adapters are sharded by the rule table, the adapters
``(in_axis, "lora")`` / ``("lora", out_axis)``; the frozen base is
gathered for the forward and takes no gradient traffic; only the
adapters' gradients are reduced). The base contributes no gradient buffers and
no optimizer moments: every base tensor has ``requires_grad`` off, and
the step takes ``torch.autograd.grad`` over the adapters alone, so
autograd forms no dW for a frozen weight (the torch counterpart of the
reference's separate ``"lora"`` collection). With the base stored in
bf16 (``base_dtype``) and the blocks rematerialised (the model's
``remat``), an 8B model fine-tunes on one card::

    full fine-tune:  params + grads + 2 x adam moments ~ 16 B a param
    LoRA fine-tune:  a bf16 base (2 B a param) + ~0.2% adapter state
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from kubeflow_tpu_torch.ops.lora import init_lora, is_lora_name
from kubeflow_tpu_torch.training.data import place_batch
from kubeflow_tpu_torch.training.lm import (
    LOSSES,
    STATIC,
    Batch,
    Params,
    Shardings,
    accumulated_value_and_grad,
    check_mesh_model,
    lm_forward_with_aux,
    local_shapes,
    mesh_value_and_grad,
    optimizer_step,
    param_shardings,
)
from kubeflow_tpu_torch.parallel import collectives
from kubeflow_tpu_torch.parallel.mesh import Mesh, check_batch_axes
from kubeflow_tpu_torch.training.optim import (
    GradientTransformation,
    global_norm,
    norm_over,
)
from kubeflow_tpu_torch.utils.trees import cast_floating


@dataclasses.dataclass
class LoRAState:
    """A train state where only ``lora`` (and its moments) update."""

    step: int
    base_params: Params  # frozen
    lora: Params  # trainable adapters
    opt_state: Any  # moments over ``lora`` only
    model: nn.Module = dataclasses.field(repr=False, metadata=STATIC)
    tx: GradientTransformation = dataclasses.field(repr=False,
                                                   metadata=STATIC)
    #: On a mesh: each base and adapter name's layout (base and
    #: adapters are this rank's pieces); None on one device.
    shardings: Optional[Shardings] = dataclasses.field(
        default=None, repr=False, metadata=STATIC)

    def variables(self) -> Params:
        """Base and adapters together, as the model applies them."""
        return {**self.base_params, **self.lora}


def create_lora_state(model: nn.Module, tx: GradientTransformation,
                      params: Params, lora: Optional[Params] = None, *,
                      seed: int = 0, mesh: Optional[Mesh] = None,
                      base_dtype: Optional[torch.dtype] = None,
                      rules: Optional[Mapping[str, Any]] = None
                      ) -> Tuple[LoRAState, Optional[Shardings]]:
    """``(state, shardings)`` for a ``lora_rank > 0`` model (``shardings``
    None without a mesh; on one, base and adapters are cut to this
    rank's pieces by the rule table). ``params`` is the
    base (adapter entries in it are taken as ``lora``); ``lora`` defaults
    to :func:`~kubeflow_tpu_torch.ops.lora.init_lora` of ``model`` with
    ``seed`` on the base's device (B zero: step 0 is the base model).
    ``base_dtype=torch.bfloat16`` stores the frozen base in bf16, every
    floating leaf (the reference's ``cast_floating``); a leaf already in
    it is kept, not copied."""
    if mesh is not None:
        check_mesh_model(model, mesh, "create_lora_state")
    base = {k: v for k, v in params.items() if not is_lora_name(k)}
    given = {k: v for k, v in params.items() if is_lora_name(k)}
    if lora is None:
        lora = given or init_lora(model, seed,
                                  next(iter(base.values())).device)
    if not lora:
        raise ValueError("the model has no LoRA adapters (lora_rank=0)")
    if base_dtype is not None:
        base = cast_floating(base, base_dtype)
    shardings = None
    if mesh is not None:
        shardings = param_shardings(model, {**base, **lora}, mesh, rules)
        local = local_shapes(model)
        base = collectives.shard_tree(base, shardings, local)
        lora = collectives.shard_tree(lora, shardings, local)
    base = {k: v.detach() for k, v in base.items()}
    lora = {k: v.detach().requires_grad_(True) for k, v in lora.items()}
    return LoRAState(step=0, base_params=base, lora=lora,
                     opt_state=tx.init(lora), model=model, tx=tx,
                     shardings=shardings), shardings


def make_lora_train_step(mesh: Optional[Mesh] = None, *,
                         objective: str = "causal",
                         aux_loss_weight: float = 0.01,
                         grad_accum: int = 1):
    """The step: gradients and updates over ``state.lora`` only, the
    base read and never written. Metrics as the pretraining step's. With
    a ``mesh``, the state must be one :func:`create_lora_state` built on
    it, and every rank calls the step with its rows."""
    loss_fn = LOSSES[objective]
    if mesh is not None:
        check_batch_axes(mesh, "make_lora_train_step", deferred=True)
        return _mesh_lora_step(mesh, loss_fn, objective, aux_loss_weight,
                               grad_accum)

    def step(state: LoRAState, batch: Batch):
        device = next(iter(state.lora.values())).device
        batch = place_batch(batch, device)

        def compute(mb):
            return lm_forward_with_aux(state.model, state.variables(), mb,
                                       loss_fn, aux_loss_weight)

        (loss, acc, aux), grads = accumulated_value_and_grad(
            compute, state.lora, batch, grad_accum, objective)
        metrics = {"loss": loss, "accuracy": acc, "aux_loss": aux,
                   "grad_norm": global_norm(grads)}
        state.opt_state = optimizer_step(state.tx, state.opt_state,
                                         state.lora, grads)
        state.step += 1
        return state, metrics

    return step


def _mesh_lora_step(mesh, loss_fn, objective, aux_loss_weight, grad_accum):
    def step(state: LoRAState, batch: Batch):
        check_mesh_model(state.model, mesh, "make_lora_train_step")
        batch = place_batch(batch, next(iter(state.lora.values())).device)
        shardings = state.shardings or {}
        (loss, acc, aux), grads = mesh_value_and_grad(
            mesh, state.model, state.lora, shardings, state.base_params,
            batch, loss_fn, aux_loss_weight, grad_accum, objective)
        with norm_over(collectives.norm_fn(shardings, mesh)):
            metrics = {"loss": loss, "accuracy": acc, "aux_loss": aux,
                       "grad_norm": global_norm(grads)}
            state.opt_state = optimizer_step(state.tx, state.opt_state,
                                             state.lora, grads)
        state.step += 1
        return state, metrics

    return step
