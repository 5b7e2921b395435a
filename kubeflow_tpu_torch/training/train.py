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

"""Training core: state and the single-device train step.

Port of the single-device half of ``kubeflow_tpu/training/train.py``;
the mesh half (sharded state, gradient all-reduce) comes with the
parallelism slice, and ``make_train_step(mesh)`` raises until then.

optax → torch.optim: ``optax.sgd(lr, momentum, nesterov=True)`` is
``torch.optim.SGD(lr=lr, momentum=momentum, nesterov=True,
dampening=0)``: both keep a trace t = g + μ·t (starting from g) and step
by −lr·(g + μ·t), over every param, BN scale and bias included. The
step updates params, optimizer state and ``batch_stats`` in place (the
reference donates its state to the same effect).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from kubeflow_tpu_torch.models.resnet import apply

Batch = Dict[str, torch.Tensor]
OptimizerFn = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]
TrainStepFn = Callable[["TrainState", Batch],
                       Tuple["TrainState", Dict[str, torch.Tensor]]]


@dataclasses.dataclass
class TrainState:
    """Step counter + params + optimizer + BN statistics, and the model
    template they apply to (the reference's ``apply_fn``)."""

    step: int
    params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    batch_stats: Dict[str, torch.Tensor]
    model: nn.Module


def sgd(learning_rate: float, momentum: float = 0.9,
        nesterov: bool = True) -> OptimizerFn:
    """``optax.sgd(learning_rate, momentum, nesterov)`` as a factory of
    ``torch.optim.SGD`` over the params it is given."""
    return lambda params: torch.optim.SGD(
        params, lr=learning_rate, momentum=momentum, nesterov=nesterov,
        dampening=0.0)


def create_train_state(model: nn.Module, tx: OptimizerFn,
                       params: Dict[str, torch.Tensor],
                       batch_stats: Dict[str, torch.Tensor]) -> TrainState:
    """A state over ``params`` (made leaf tensors that require grad,
    in place) and ``batch_stats``, with the optimizer ``tx`` builds."""
    params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    return TrainState(step=0, params=params,
                      optimizer=tx(list(params.values())),
                      batch_stats=dict(batch_stats), model=model)


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of the integer-label cross entropy, in fp32."""
    return F.cross_entropy(logits.float(), labels.long())


def make_train_step(
    mesh: Optional[object] = None,
    *,
    loss_fn: Callable[[torch.Tensor, torch.Tensor],
                      torch.Tensor] = softmax_cross_entropy,
) -> TrainStepFn:
    """The train step: forward in train mode (BN statistics from the
    batch, running statistics updated), loss, gradients, one optimizer
    step. Metrics are device scalars — ``loss``, ``accuracy`` and
    ``grad_norm`` (the L2 norm over all gradients, ``optax.global_norm``)
    — so a loop of steps never waits on the host."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded train step (a mesh) is not ported yet")

    def step(state: TrainState, batch: Batch):
        logits = apply(state.model, state.params, state.batch_stats,
                       batch["inputs"], train=True)
        loss = loss_fn(logits, batch["labels"])
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in state.params.values()]
        metrics = {
            "loss": loss.detach(),
            "accuracy": (logits.argmax(-1) == batch["labels"]).float().mean(),
            "grad_norm": torch.nn.utils.get_total_norm(grads),
        }
        state.optimizer.step()
        state.step += 1
        return state, metrics

    return step
