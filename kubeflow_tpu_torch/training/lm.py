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


"""Language-model training: the state and the causal-LM train step.

The port of ``kubeflow_tpu/training/lm.py``, for one device. The
reference's mesh half (params sharded by the TP rule table, batches
over ``(data, fsdp)``) is ROADMAP A14: a mesh raises.

The step is eager PyTorch around the model's kernels: a forward
through :func:`~kubeflow_tpu_torch.models.llama.apply`, the loss in
fp32, ``torch.autograd.grad`` over the trainable tensors only, then the
optimizer of :mod:`training/optim.py` (optax's semantics), applied in
place. Metrics are device scalars, so a loop of steps never waits on
the host. Batches may be numpy (as the reference's generators yield
them) or tensors; they are moved to the params' device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from kubeflow_tpu_torch.models.llama import Llama, apply
from kubeflow_tpu_torch.ops.moe import collect_losses
from kubeflow_tpu_torch.training.data import place_batch
from kubeflow_tpu_torch.training.optim import (
    GradientTransformation,
    apply_updates,
    global_norm,
)

Batch = Dict[str, Union[np.ndarray, torch.Tensor]]
Params = Dict[str, torch.Tensor]
#: A field of a train state that is not part of its tree (checkpoints
#: skip it), as ``struct.field(pytree_node=False)`` in the reference.
STATIC = {"static": True}


def _mesh_unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the sharded (mesh) trainer is not ported yet (ROADMAP "
        "A14); the port trains on one device")


@dataclasses.dataclass
class LMState:
    """Step counter, params (leaf tensors that require grad), optimizer
    state, and the model template and optimizer they go with."""

    step: int
    params: Params
    opt_state: Any
    model: nn.Module = dataclasses.field(repr=False, metadata=STATIC)
    tx: GradientTransformation = dataclasses.field(repr=False,
                                                   metadata=STATIC)


def create_lm_state(model: nn.Module, tx: GradientTransformation,
                    params: Params, mesh: Optional[object] = None
                    ) -> Tuple[LMState, None]:
    """``(state, None)`` over ``params`` (e.g. ``models.convert.
    init_params`` of a ``param_dtype="float32"`` model: fp32 masters),
    each made a leaf tensor that requires grad. The ``None`` stands for
    the reference's shardings."""
    if mesh is not None:
        raise _mesh_unsupported("create_lm_state(mesh=...)")
    params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    return LMState(step=0, params=params, opt_state=tx.init(params),
                   model=model, tx=tx), None


def model_args(batch: Mapping[str, torch.Tensor]) -> Tuple:
    """A batch's positional model inputs, the reference's: a BERT batch
    (``type_ids``, ``valid``) gives ``(input_ids, type_ids, valid)``, a
    causal batch ``(input_ids,)``."""
    if "type_ids" in batch or "valid" in batch:
        return (batch["input_ids"], batch.get("type_ids"),
                batch.get("valid"))
    return (batch["input_ids"],)


def apply_lm(model: nn.Module, params: Params,
             batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The model applied to a batch's :func:`model_args`. A Llama takes
    the reference's Llama's positional meaning of them: the second is its
    ``positions`` and the third its ``train`` flag, which it ignores (so
    a BERT batch fed to a Llama, as ``--objective mlm`` with a Llama
    does, runs as in the reference)."""
    args = model_args(batch)
    if isinstance(model, Llama):
        args = args[:2]
    return apply(model, params, *args)


def lm_targets(logits: torch.Tensor, batch: Mapping[str, torch.Tensor],
               objective: str
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(logits_used, targets, weights)`` under the batch conventions
    of the reference, the one source of truth for the losses and
    evaluation. mlm: ``mlm_labels`` weighted by ``mlm_weights``. causal:
    ``targets`` (pre-shifted) if present, else ``input_ids`` shifted
    left; ``loss_weights`` (optional) masks padding and is sliced to
    match when the shift is implicit."""
    if objective == "mlm":
        return logits, batch["mlm_labels"], batch["mlm_weights"].float()
    if "targets" in batch:
        targets, logits_used = batch["targets"], logits
    else:
        targets = batch["input_ids"][:, 1:]
        logits_used = logits[:, :-1]
    weights = batch.get("loss_weights")
    if weights is None:
        weights = torch.ones(targets.shape, dtype=torch.float32,
                             device=targets.device)
    elif "targets" not in batch:
        weights = weights[:, 1:]
    return logits_used, targets, weights.float()


def lm_token_weight(batch: Mapping[str, torch.Tensor],
                    objective: str) -> torch.Tensor:
    """The batch's total token weight under :func:`lm_targets`'
    conventions: the normalizer that makes gradient accumulation over
    unevenly weighted microbatches the full-batch gradient."""
    if objective == "mlm":
        return batch["mlm_weights"].float().sum()
    weights = batch.get("loss_weights")
    device = batch["input_ids"].device
    if "targets" in batch:
        shape = batch["targets"].shape
        if weights is None:
            return torch.tensor(float(shape[0] * shape[1]), device=device)
        return weights.float().sum()
    b, l = batch["input_ids"].shape
    if weights is None:
        return torch.tensor(float(b * (l - 1)), device=device)
    return weights[:, 1:].float().sum()


def softmax_cross_entropy_with_integer_labels(
        logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's: ``logsumexp(logits) - logits[label]`` per position, in
    the logits' dtype (fp32 here)."""
    flat = logits.reshape(-1, logits.shape[-1])
    ce = F.cross_entropy(flat, labels.reshape(-1).long(), reduction="none")
    return ce.reshape(labels.shape)


def _weighted_loss(logits, batch, objective):
    logits, targets, weights = lm_targets(logits, batch, objective)
    ce = softmax_cross_entropy_with_integer_labels(logits, targets)
    denom = torch.clamp_min(weights.sum(), 1.0)
    loss = (ce * weights).sum() / denom
    correct = (logits.argmax(-1) == targets).float()
    acc = (correct * weights).sum() / denom
    return loss, acc


def mlm_loss(logits: torch.Tensor, batch) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Masked-LM loss: cross entropy where ``mlm_weights`` is 1."""
    return _weighted_loss(logits, batch, "mlm")


def causal_lm_loss(logits: torch.Tensor, batch) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """Next-token loss. ``targets`` defaults to input_ids shifted left;
    ``loss_weights`` (optional) masks padding."""
    return _weighted_loss(logits, batch, "causal")


LOSSES = {"mlm": mlm_loss, "causal": causal_lm_loss}


def lm_forward_with_aux(model: nn.Module, params: Params, batch,
                        loss_fn, aux_loss_weight: float):
    """The forward both trainers share: ``(total_loss, (loss, accuracy,
    aux))``. ``aux`` is the sum of the auxiliary losses the forward sows
    (the MoE load-balance loss of every MoE block, ops/moe.py: the
    reference's ``"losses"`` collection); a model that sows none gives
    0."""
    with collect_losses() as sown:
        logits = apply_lm(model, params, batch)
    loss, acc = loss_fn(logits, batch)
    aux = torch.zeros((), dtype=loss.dtype, device=loss.device)
    for term in sown:
        aux = aux + term.to(loss.dtype)
    return loss + aux_loss_weight * aux, (loss, acc, aux)


def accumulated_value_and_grad(
        compute: Callable[[Batch], Tuple[torch.Tensor, Tuple]],
        trainable: Params, batch: Mapping[str, torch.Tensor], n: int,
        objective: str = "causal"):
    """``((loss, acc, aux), grads)`` over ``n`` sequential microbatches.

    ``compute(microbatch) -> (total_loss, (loss, acc, aux))`` applies
    the current ``trainable`` tensors; ``grads`` maps each of their names
    to its gradient (``torch.autograd.grad``: nothing accumulates into
    ``.grad``, and no gradient is formed for a tensor not in
    ``trainable``). The batch's leading dim splits into ``n`` equal
    microbatches run one after another, so live activation memory drops
    about n-fold while the optimizer sees the exact full-batch gradient:
    each microbatch's CE is re-weighted by its share of the batch's
    token weight (:func:`lm_token_weight`), and the aux term averages
    equally over microbatches."""
    names = list(trainable)
    tensors = [trainable[k] for k in names]
    if n <= 1:
        total, (loss, acc, aux) = compute(batch)
        grads = torch.autograd.grad(total, tensors)
        return (loss.detach(), acc.detach(), aux.detach()), dict(
            zip(names, grads))
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch dim {v.shape[0]} not divisible by "
                             f"grad_accum={n}")
    rows = next(iter(batch.values())).shape[0] // n
    total_w = torch.clamp_min(lm_token_weight(batch, objective), 1.0)
    acc_g = None
    loss_acc = acc_acc = aux_acc = 0.0
    for i in range(n):
        mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        frac = lm_token_weight(mb, objective) / total_w
        total, (loss, acc, aux) = compute(mb)
        aux_term = total - loss  # aux_loss_weight · aux, by construction
        g = torch.autograd.grad(loss * frac + aux_term / n, tensors)
        acc_g = list(g) if acc_g is None else [a + b for a, b in
                                               zip(acc_g, g)]
        loss_acc = loss_acc + loss.detach() * frac
        acc_acc = acc_acc + acc.detach() * frac
        aux_acc = aux_acc + aux.detach() / n
    return (loss_acc, acc_acc, aux_acc), dict(zip(names, acc_g))


def _device_of(params: Params) -> torch.device:
    return next(iter(params.values())).device


def optimizer_step(tx: GradientTransformation, opt_state, params: Params,
                   grads: Params):
    """One optimizer update of ``params`` in place; returns the new
    optimizer state. ``grads`` is consumed."""
    with torch.no_grad(), torch.profiler.record_function("Optimizer.step"):
        updates, opt_state = tx.update(grads, opt_state, params)
        apply_updates(params, updates)
    return opt_state


def make_lm_train_step(mesh: Optional[object] = None, *,
                       objective: str = "causal",
                       aux_loss_weight: float = 0.01,
                       grad_accum: int = 1):
    """The train step for an :class:`LMState`: forward, loss, gradients
    over every param, one optimizer update. The state is updated in
    place and returned (what the reference's buffer donation gives).
    ``objective``: "causal" (Llama) or "mlm"; ``grad_accum > 1`` splits
    each batch into that many sequential microbatches
    (:func:`accumulated_value_and_grad`). Metrics: ``loss``,
    ``accuracy``, ``aux_loss`` and ``grad_norm`` (of the raw
    gradients), device scalars. A ``mesh`` raises (ROADMAP A14)."""
    if mesh is not None:
        raise _mesh_unsupported("make_lm_train_step(mesh=...)")
    loss_fn = LOSSES[objective]

    def step(state: LMState, batch: Batch):
        batch = place_batch(batch, _device_of(state.params))

        def compute(mb):
            return lm_forward_with_aux(state.model, state.params, mb,
                                       loss_fn, aux_loss_weight)

        (loss, acc, aux), grads = accumulated_value_and_grad(
            compute, state.params, batch, grad_accum, objective)
        metrics = {"loss": loss, "accuracy": acc, "aux_loss": aux,
                   "grad_norm": global_norm(grads)}
        state.opt_state = optimizer_step(state.tx, state.opt_state,
                                         state.params, grads)
        state.step += 1
        return state, metrics

    return step
