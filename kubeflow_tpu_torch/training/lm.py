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

The port of ``kubeflow_tpu/training/lm.py``, on one device or on a
gang's mesh (``parallel/mesh.py``) over the batch axes (dcn_data, data,
fsdp). On a mesh each rank holds its rows of the global batch and its
pieces of the params, sharded by the rule table
(``parallel/tensor_parallel.py``: ``embed`` dims over fsdp), and the
optimizer moments mirror them. A step all-gathers the sharded leaves,
takes the gradient of its rows' share of the global loss (a masked loss
divides by the global batch's token weight, all-reduced first, so
unequal counts across ranks still give the reference's global mean),
reduce-scatters the sharded leaves' gradients over fsdp and sums the
rest over the batch axes, then runs the optimizer on its pieces, with
the global norm taken over the shards (``optim.norm_over``). That is
the step XLA derives from the reference's shardings. On a ``tensor``
axis (a Llama or BERT built on the mesh, ``Llama(mesh=)``,
``Bert(mesh=)``) each rank also holds its tensor pieces, the model
issues the tensor collectives itself, and the step gathers and
reduce-scatters over fsdp alone; the loss runs on the all-gathered
logits. An MoE Llama built on the mesh holds its ``expert`` pieces (its
E/X experts) the same way, routes the global batch and sows the global
batch's load-balance loss (``ops/moe.py``), so the ``aux_loss`` metric
is the global batch's; with grad accumulation its microbatches are the
reference's, runs of the global batch (:func:`global_microbatches`).
``seq``, and ``tensor`` or ``expert`` on a model with no param on them,
are replicated axes: each such rank holds the whole params and its
batch position's rows and takes the unmeshed step (no gradient is
summed over them). ``pipeline`` runs on the pipeline trainer
(``training/pipeline_lm.py``). On an nccl group of one rank
every collective is still launched, and the meshed step gives the
unmeshed step's bits.

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

from kubeflow_tpu_torch.models.convert import flax_key, torch_spec
from kubeflow_tpu_torch.models.llama import Llama, apply
from kubeflow_tpu_torch.ops.moe import collect_losses
from kubeflow_tpu_torch.parallel import collectives
from kubeflow_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    Mesh,
    Sharding,
    check_batch_axes,
    runs_axis,
)
from kubeflow_tpu_torch.parallel.tensor_parallel import (
    rules_for,
    variables_sharding,
)
from kubeflow_tpu_torch.training.data import place_batch
from kubeflow_tpu_torch.training.optim import (
    GradientTransformation,
    apply_updates,
    global_norm,
    norm_over,
)

Batch = Dict[str, Union[np.ndarray, torch.Tensor]]
Params = Dict[str, torch.Tensor]
#: A field of a train state that is not part of its tree (checkpoints
#: skip it), as ``struct.field(pytree_node=False)`` in the reference.
STATIC = {"static": True}


Shardings = Dict[str, Sharding]


@dataclasses.dataclass
class LMState:
    """Step counter, params (leaf tensors that require grad), optimizer
    state, and the model template and optimizer they go with. On a
    mesh, ``params`` and the moments are this rank's pieces and
    ``shardings`` maps each param name to its layout (the port's tensor
    layout); the moments mirror their params by name."""

    step: int
    params: Params
    opt_state: Any
    model: nn.Module = dataclasses.field(repr=False, metadata=STATIC)
    tx: GradientTransformation = dataclasses.field(repr=False,
                                                   metadata=STATIC)
    shardings: Optional[Shardings] = dataclasses.field(
        default=None, repr=False, metadata=STATIC)


def param_shardings(model: nn.Module, params: Mapping[str, torch.Tensor],
                    mesh: Mesh, rules: Optional[Mapping[str, Any]] = None
                    ) -> Shardings:
    """Each port param's sharding by the rule table over the model's
    ``logical_axes`` (the reference's ``sharded_collection_init``; a
    tensor-parallel Llama's k/v kernels split by kv-head group, its
    ``split_axes``), carried into the port's layout of the leaf (a
    kernel's dims are the Flax kernel's, transposed)."""
    keys = {name: flax_key(name) for name in params}
    flax_sh = variables_sharding(mesh, model, keys.values(),
                                 rules_for(mesh, rules))
    return {n: Sharding(mesh, torch_spec(keys[n], flax_sh[keys[n]].spec,
                                         t.dim()))
            for n, t in params.items()}


def local_shapes(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """Each parameter's shape in the model's template: a tensor-parallel
    model's tensor pieces, whole over fsdp."""
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def _leaves(tree: Mapping[str, torch.Tensor]) -> Params:
    return {k: v.detach().requires_grad_(True) for k, v in tree.items()}


def create_lm_state(model: nn.Module, tx: GradientTransformation,
                    params: Params, mesh: Optional[Mesh] = None,
                    rules: Optional[Mapping[str, Any]] = None
                    ) -> Tuple[LMState, Optional[Shardings]]:
    """``(state, shardings)`` over ``params`` (e.g. ``models.convert.
    init_params`` of a ``param_dtype="float32"`` model: fp32 masters,
    or params carried across from the reference), each made a leaf
    tensor that requires grad. Without a mesh ``shardings`` is None; on
    one, ``params`` (whole) are cut to this rank's pieces by
    :func:`param_shardings` and the optimizer state is built over the
    pieces."""
    if mesh is None:
        params = _leaves(params)
        return LMState(step=0, params=params, opt_state=tx.init(params),
                       model=model, tx=tx), None
    check_mesh_model(model, mesh, "create_lm_state")
    shardings = param_shardings(model, params, mesh, rules)
    params = _leaves(collectives.shard_tree(params, shardings,
                                            local_shapes(model)))
    return LMState(step=0, params=params, opt_state=tx.init(params),
                   model=model, tx=tx, shardings=shardings), shardings


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


def _weighted_loss(logits, batch, objective, denom=None):
    """(loss, accuracy) weighted by the batch's token weights, divided by
    ``denom`` (default: the batch's own weight, at least 1; a mesh step
    passes the global batch's)."""
    logits, targets, weights = lm_targets(logits, batch, objective)
    ce = softmax_cross_entropy_with_integer_labels(logits, targets)
    if denom is None:
        denom = torch.clamp_min(weights.sum(), 1.0)
    loss = (ce * weights).sum() / denom
    correct = (logits.argmax(-1) == targets).float()
    acc = (correct * weights).sum() / denom
    return loss, acc


def mlm_loss(logits: torch.Tensor, batch, denom=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked-LM loss: cross entropy where ``mlm_weights`` is 1."""
    return _weighted_loss(logits, batch, "mlm", denom)


def causal_lm_loss(logits: torch.Tensor, batch, denom=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token loss. ``targets`` defaults to input_ids shifted left;
    ``loss_weights`` (optional) masks padding."""
    return _weighted_loss(logits, batch, "causal", denom)


LOSSES = {"mlm": mlm_loss, "causal": causal_lm_loss}


def lm_forward_with_aux(model: nn.Module, params: Params, batch,
                        loss_fn, aux_loss_weight: float, denom=None):
    """The forward both trainers share: ``(total_loss, (loss, accuracy,
    aux))``. ``aux`` is the sum of the auxiliary losses the forward sows
    (the MoE load-balance loss of every MoE block, ops/moe.py: the
    reference's ``"losses"`` collection); a model that sows none gives
    0. ``denom`` is the loss's divisor (the loss function's default when
    None)."""
    with collect_losses() as sown:
        logits = apply_lm(model, params, batch)
    loss, acc = (loss_fn(logits, batch) if denom is None
                 else loss_fn(logits, batch, denom))
    aux = torch.zeros((), dtype=loss.dtype, device=loss.device)
    for term in sown:
        aux = aux + term.to(loss.dtype)
    return loss + aux_loss_weight * aux, (loss, acc, aux)


def accumulated_value_and_grad(
        compute: Callable[[Batch], Tuple[torch.Tensor, Tuple]],
        trainable: Params, batch: Mapping[str, torch.Tensor], n: int,
        objective: str = "causal",
        total_weight: Optional[torch.Tensor] = None):
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
    equally over microbatches. ``total_weight`` (a mesh step's: the
    global batch's token weight, at least 1) replaces the batch's own as
    the divisor, so each rank's gradient is its share of the global
    loss's."""
    names = list(trainable)
    tensors = [trainable[k] for k in names]
    if n <= 1:
        total, (loss, acc, aux) = (compute(batch) if total_weight is None
                                   else compute(batch, total_weight))
        grads = torch.autograd.grad(total, tensors)
        return (loss.detach(), acc.detach(), aux.detach()), dict(
            zip(names, grads))
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch dim {v.shape[0]} not divisible by "
                             f"grad_accum={n}")
    rows = next(iter(batch.values())).shape[0] // n
    total_w = (torch.clamp_min(lm_token_weight(batch, objective), 1.0)
               if total_weight is None else total_weight)
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


def check_mesh_model(model: nn.Module, mesh: Mesh, what: str) -> None:
    """Raise where a mesh step cannot give the reference's result: a
    live model axis the model does not run (``tensor`` runs on the Llama
    and BERT, ``expert`` on an MoE Llama, each as a replicated axis on a
    model with no param on it; ``pipeline`` on the pipeline trainer), a
    model with a live ``tensor`` axis not built on it, or an MoE model on
    a mesh of more than one rank not built on it (its routing groups and
    load-balance loss are the global batch's, ``MoE(mesh=)``)."""
    check_batch_axes(mesh, what, model)
    if getattr(model, "num_experts", 0) and mesh.size > 1:
        built = getattr(model, "moe_mesh", None)
        if built is None or built.shape != mesh.shape:
            raise ValueError(
                f"{what}: an MoE model on a mesh of {mesh.size} ranks needs "
                f"the model built on it (Llama(mesh=...))")
    tensor = mesh.shape["tensor"]
    if runs_axis(model, "tensor") and getattr(model, "tensor", 1) != tensor:
        raise ValueError(
            f"{what}: a mesh with tensor={tensor} needs the model built "
            f"on it ({type(model).__name__}(mesh=...)); this one has "
            f"tensor={getattr(model, 'tensor', 1)}")


def global_microbatches(batch: Mapping[str, torch.Tensor], mesh: Mesh,
                        n: int) -> Dict[str, torch.Tensor]:
    """This rank's rows of each of the reference's ``n`` microbatches,
    in microbatch order: the reference splits the *global* batch into
    ``n`` runs of rows, so microbatch i is global rows ``[i·B/n,
    (i+1)·B/n)``, of which this batch rank takes its share. An MoE's
    routing groups and load-balance loss are functions of a microbatch's
    tokens, so its microbatches must be the reference's; a dense model's
    losses are per token and need no exchange. The rows are all-gathered
    over the batch line (ids and masks: a few bytes a token)."""
    ranks = mesh.axes_size(BATCH_AXES)
    pos = mesh.index(BATCH_AXES)
    out = {}
    for k, v in batch.items():
        whole = collectives.gather_from(v, mesh, BATCH_AXES, 0)
        size = whole.shape[0]
        if size % (n * ranks):
            raise ValueError(f"global batch {size} does not split into "
                             f"{n} microbatches over {ranks} batch ranks")
        share = size // (n * ranks)
        out[k] = whole.reshape(n, ranks, share, *whole.shape[1:])[
            :, pos].reshape(n * share, *whole.shape[1:])
    return out


def mesh_value_and_grad(mesh: Mesh, model: nn.Module, trainable: Params,
                        shardings: Mapping[str, Optional[Sharding]],
                        fixed: Params, batch, loss_fn, aux_loss_weight,
                        grad_accum: int, objective: str):
    """A mesh step's forward and backward: ``((loss, acc, aux), grads)``
    with the metrics of the global batch and each gradient this rank's
    piece of the global batch's. Sharded ``trainable`` leaves are
    all-gathered for the forward (a replicated one is used as it is);
    ``fixed`` (frozen leaves) are gathered too and take no gradient.
    Only fsdp pieces are gathered: a tensor piece is what the model
    computes on."""
    gathered = {k: collectives.gather_leaf(v.detach(), shardings.get(k),
                                           mesh, ("fsdp",))
                for k, v in fixed.items()}
    full = {}
    for k, v in trainable.items():
        sh = shardings.get(k)
        full[k] = v if collectives.fsdp_dim(sh) is None else (
            collectives.gather_leaf(v.detach(), sh, mesh, ("fsdp",))
            .requires_grad_(True))
    if (grad_accum > 1 and getattr(model, "num_experts", 0)
            and mesh.axes_size(BATCH_AXES) > 1):
        batch = global_microbatches(batch, mesh, grad_accum)
    total_w = torch.clamp_min(collectives.global_sum(
        lm_token_weight(batch, objective), mesh), 1.0)

    def compute(mb, denom=None):
        return lm_forward_with_aux(model, {**gathered, **full}, mb, loss_fn,
                                   aux_loss_weight, denom)

    (loss, acc, aux), grads = accumulated_value_and_grad(
        compute, full, batch, grad_accum, objective, total_w)
    grads = {k: collectives.reduce_grad(g, shardings.get(k), mesh)
             for k, g in grads.items()}
    # The aux loss is the global batch's on every rank already (an MoE
    # sums its statistics over the batch line, ops/moe.py).
    metrics = (collectives.global_sum(loss, mesh),
               collectives.global_sum(acc, mesh), aux)
    return metrics, grads


def make_lm_train_step(mesh: Optional[Mesh] = None, *,
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
    gradients), device scalars. With a ``mesh`` the state must be one
    :func:`create_lm_state` built on it, and every rank of the gang
    calls the step with its rows of the global batch."""
    loss_fn = LOSSES[objective]
    if mesh is not None:
        check_batch_axes(mesh, "make_lm_train_step", deferred=True)
        return _mesh_lm_step(mesh, loss_fn, objective, aux_loss_weight,
                             grad_accum)

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


def _mesh_lm_step(mesh, loss_fn, objective, aux_loss_weight, grad_accum):
    def step(state: LMState, batch: Batch):
        check_mesh_model(state.model, mesh, "make_lm_train_step")
        batch = place_batch(batch, _device_of(state.params))
        shardings = state.shardings or {}
        (loss, acc, aux), grads = mesh_value_and_grad(
            mesh, state.model, state.params, shardings, {}, batch, loss_fn,
            aux_loss_weight, grad_accum, objective)
        with norm_over(collectives.norm_fn(shardings, mesh)):
            metrics = {"loss": loss, "accuracy": acc, "aux_loss": aux,
                       "grad_norm": global_norm(grads)}
            state.opt_state = optimizer_step(state.tx, state.opt_state,
                                             state.params, grads)
        state.step += 1
        return state, metrics

    return step
