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

"""Training core: state and the vision train step.

Port of ``kubeflow_tpu/training/train.py``, on one device or on a
gang's mesh over the batch axes. On a mesh (:func:`place_state`), the
params above ``2**18`` elements are split over fsdp along their largest
divisible dim (the reference's :func:`state_sharding`, by the Flax
shape), the momentum traces follow their params, and BN statistics are
replicated. A step gathers the sharded params, runs the forward with
every BN layer on the sync route (``ops/batch_norm.py``
``sync_batch_norm``: the global batch's statistics, as the reference's
BN has them on a batch-sharded mesh), takes the gradient of its rows'
share of the global mean loss, reduce-scatters the sharded params'
gradients over fsdp, sums the rest over the batch axes, and steps the
optimizer on its pieces. ``seq``, ``tensor`` and ``expert`` are
replicated axes (each such rank takes the unmeshed step on its batch
position's rows), as in the reference, whose vision trainer lays its
params out by fsdp alone (``state_sharding``) and splits the batch over
(dcn_data, data, fsdp), so no param or row is split over them;
``pipeline`` raises (the pipeline trainer stages a Llama's blocks).

optax → torch.optim: ``optax.sgd(lr, momentum, nesterov=True)`` is
``torch.optim.SGD(lr=lr, momentum=momentum, nesterov=True,
dampening=0)``: both keep a trace t = g + μ·t (starting from g) and step
by −lr·(g + μ·t), over every param, BN scale and bias included. The
step updates params, optimizer state and ``batch_stats`` in place (the
reference donates its state to the same effect).
"""

from __future__ import annotations

import dataclasses
import types
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from kubeflow_tpu_torch.models.convert import flax_key, flax_shape, torch_spec
from kubeflow_tpu_torch.models.layers import apply
from kubeflow_tpu_torch.ops.batch_norm import SyncGroup, sync_batch_norm
from kubeflow_tpu_torch.parallel import collectives
from kubeflow_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    Mesh,
    Sharding,
    check_batch_axes,
    fsdp_params_sharding,
)
from kubeflow_tpu_torch.training import data

Batch = Dict[str, torch.Tensor]
#: The model axes the vision trainer runs as replicated axes (beside
#: ``seq``): its params are laid out by fsdp alone.
REPLICATED_AXES = ("tensor", "expert")
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
    #: On a mesh (:func:`place_state`): each param name's layout; the
    #: params and momentum traces are this rank's pieces.
    shardings: Optional[Dict[str, Sharding]] = dataclasses.field(
        default=None, repr=False, metadata={"static": True})


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


def state_sharding(mesh: Mesh, params: Dict[str, torch.Tensor]
                   ) -> Dict[str, Sharding]:
    """Each param's sharding, the reference's rule for conv nets:
    ``fsdp_params_sharding`` at ``min_weight_size=2**18`` over the Flax
    shapes (large kernels split over fsdp, the small late 1×1 kernels and
    everything else replicated), carried into the port's layouts. BN
    statistics are replicated."""
    keys = {n: flax_key(n) for n in params}
    flax_sh = fsdp_params_sharding(
        mesh, {keys[n]: types.SimpleNamespace(
            shape=flax_shape(keys[n], t.shape)) for n, t in params.items()},
        min_weight_size=2 ** 18)
    return {n: Sharding(mesh, torch_spec(keys[n], flax_sh[keys[n]].spec,
                                         t.dim()))
            for n, t in params.items()}


def place_state(mesh: Mesh, state: TrainState) -> TrainState:
    """A whole state as this rank's: params cut to their pieces by
    :func:`state_sharding` (the optimizer, rebuilt over the pieces,
    starts with no momentum, as a fresh state's), statistics whole, on
    the mesh's device."""
    check_batch_axes(mesh, "place_state", replicated_ok=REPLICATED_AXES)
    shardings = state_sharding(mesh, state.params)
    pieces = collectives.shard_tree(
        {k: v.detach().to(mesh.device) for k, v in state.params.items()},
        shardings)
    params = {k: v.detach().requires_grad_(True) for k, v in pieces.items()}
    optimizer = type(state.optimizer)(list(params.values()),
                                      **state.optimizer.defaults)
    return dataclasses.replace(
        state, params=params, optimizer=optimizer,
        batch_stats={k: v.to(mesh.device)
                     for k, v in state.batch_stats.items()},
        shardings=shardings)


def place_batch(mesh: Mesh, batch: Batch) -> Batch:
    """A batch on the mesh's device: this rank's rows of the global
    batch, as a gang's sources yield them (``data.host_shard_range``,
    the reference's per-process data under ``batch_sharding``)."""
    return data.place_batch(batch, mesh.device)


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
    — so a loop of steps never waits on the host. With a ``mesh`` the
    state must be one :func:`place_state` placed, and every rank calls
    the step with its rows of the global batch."""
    if mesh is not None:
        check_batch_axes(mesh, "make_train_step",
                         replicated_ok=REPLICATED_AXES)
        return _mesh_train_step(mesh, loss_fn)

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


def _mesh_train_step(mesh: Mesh, loss_fn) -> TrainStepFn:
    ranks = mesh.axes_size(BATCH_AXES)
    sync = SyncGroup(
        reduce=lambda t: collectives.all_reduce_sum(t, mesh),
        index=mesh.index(BATCH_AXES), size=ranks)

    def step(state: TrainState, batch: Batch):
        shardings = state.shardings or {}
        full = {}
        for k, v in state.params.items():
            sh = shardings.get(k)
            full[k] = v if collectives.fsdp_dim(sh) is None else (
                collectives.gather_leaf(v.detach(), sh, mesh)
                .requires_grad_(True))
        with sync_batch_norm(sync):
            logits = apply(state.model, full, state.batch_stats,
                           batch["inputs"], train=True)
        # This rank's share of the global mean: a mean over equal row
        # counts, so a factor of 1 (exact) on one rank.
        loss = loss_fn(logits, batch["labels"]) * (1.0 / ranks)
        grads = torch.autograd.grad(loss, list(full.values()))
        grads = {k: collectives.reduce_grad(g, shardings.get(k), mesh)
                 for k, g in zip(full, grads)}
        correct = (logits.argmax(-1) == batch["labels"]).float().mean()
        metrics = {
            "loss": collectives.global_sum(loss, mesh),
            "accuracy": collectives.batch_mean(correct, mesh),
            "grad_norm": _grad_norm(grads, shardings, mesh),
        }
        for k, p in state.params.items():
            p.grad = grads[k]
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state, metrics

    return step


def _grad_norm(grads, shardings, mesh) -> torch.Tensor:
    """``torch.nn.utils.get_total_norm`` of gradients held as pieces:
    each leaf's norm over its whole (squares summed over every axis it
    is split on; a replicated leaf's norm is every rank's already), then
    the norm of the leaves' norms."""
    norms = []
    for k, g in grads.items():
        n = torch.linalg.vector_norm(g)
        axes = tuple(collectives.dims_by_axis(shardings.get(k)))
        if axes:
            sq = collectives.all_reduce_sum(n * n, mesh, axes)
            n = torch.sqrt(sq)
        norms.append(n)
    return torch.linalg.vector_norm(torch.stack(norms))
