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

"""Pipeline-parallel LM training: a Llama's blocks on the ``pipeline``
axis.

The port of ``kubeflow_tpu/training/pipeline_lm.py``. A Llama's blocks
are partitioned into contiguous stage groups; each stage's layer params
are stacked (``stages``: ``[S, L/S, ...]``, or ``[v, n, L/S, ...]`` for
the interleaved schedule) and each rank of the pipeline line holds only
its own stages. The GPipe or circular schedule
(``parallel/pipeline.py``) streams microbatches stage to stage, and the
batch axes split the rows (pp × dp: each rank feeds its own rows). The
token embedding, the final norm and the head run outside the pipeline,
replicated on every rank. The state's tree is the reference's:
``tok_embed``, ``stages``, ``final_norm``, ``lm_head``.

The stage function runs the port's own :class:`~kubeflow_tpu_torch.
models.llama.LlamaBlock`, the block the unpipelined model runs, one
layer after another. A block returns ``(x, delta)`` and the next
block's ``attn_norm`` adds ``delta`` in its launch; a stage adds its
last block's ``delta`` before it hands ``x`` on, and the next stage's
first block takes the plain norm. Both forms give the same bits: the
fused norm rounds ``x + delta`` to the model's dtype before it
normalises it, as the add and the plain norm do.

The step's gradients are summed over the batch axes only (a stage's
leaves are its rank's own; the replicated leaves' gradients are equal
on every rank of the pipeline line, counted once), and the global norm
the clip takes is over every rank's stage leaves plus the replicated
leaves once (``parallel/collectives.py`` ``sharded_global_norm``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from kubeflow_tpu_torch.models.llama import Llama, LlamaBlock
from kubeflow_tpu_torch.parallel import collectives
from kubeflow_tpu_torch.parallel.mesh import Mesh, Sharding, check_batch_axes
from kubeflow_tpu_torch.parallel.pipeline import (
    interleave_stage_params,
    spmd_pipeline,
    spmd_pipeline_interleaved,
    stack_stage_params,
    stage_piece,
)
from kubeflow_tpu_torch.training.data import place_batch
from kubeflow_tpu_torch.training.lm import (
    LOSSES,
    STATIC,
    Batch,
    Params,
    lm_token_weight,
    optimizer_step,
)
from kubeflow_tpu_torch.training.optim import (
    GradientTransformation,
    global_norm,
    norm_over,
)

PIPELINE_AXIS = "pipeline"
STAGES = "stages."


@dataclasses.dataclass
class PipelineLMState:
    """Step, staged params (``tok_embed.weight``, ``stages.<block
    param>`` — this rank's stages — ``final_norm.scale``,
    ``lm_head.weight``), optimizer state over them, and the model
    template, optimizer and shardings they go with."""

    step: int
    params: Params
    opt_state: Any
    model: nn.Module = dataclasses.field(repr=False, metadata=STATIC)
    tx: GradientTransformation = dataclasses.field(repr=False,
                                                   metadata=STATIC)
    shardings: Optional[Dict[str, Sharding]] = dataclasses.field(
        default=None, repr=False, metadata=STATIC)


def partition_llama_params(params: Mapping[str, torch.Tensor],
                           n_stages: int) -> Params:
    """A Llama's port params (``layers.{i}.<name>``) regrouped into the
    staged layout: ``stages.<name>`` leaves ``[n_stages,
    layers_per_stage, ...]``, contiguous layer groups."""
    layers = sorted({int(k.split(".")[1]) for k in params
                     if k.startswith("layers.")})
    if not layers:
        raise ValueError("param tree has no layers.<i> subtrees")
    if len(layers) % n_stages:
        raise ValueError(
            f"{len(layers)} layers not divisible into {n_stages} stages")
    per = len(layers) // n_stages
    names = sorted(k.split(".", 2)[2] for k in params
                   if k.startswith("layers.0."))
    stage_trees = [{n: torch.stack([params[f"layers.{s * per + j}.{n}"]
                                    for j in range(per)])
                    for n in names} for s in range(n_stages)]
    stacked = stack_stage_params(stage_trees)
    return {"tok_embed.weight": params["tok_embed.weight"],
            **{STAGES + n: t for n, t in stacked.items()},
            "final_norm.scale": params["final_norm.scale"],
            "lm_head.weight": params["lm_head.weight"]}


def _block_for(model: Llama) -> Tuple[LlamaBlock, bool]:
    """The block template every stage runs, and whether it is
    rematerialized; MoE, cache and LoRA blocks raise, as the
    reference's."""
    if model.num_experts or model.cache_size or model.lora_rank:
        raise ValueError(
            "pipeline trainer supports dense training blocks only "
            "(no MoE/cache/LoRA) — compose ep or LoRA with dp/fsdp/tp "
            "presets instead")
    if getattr(model, "tensor", 1) != 1:
        raise ValueError("the pipeline trainer's blocks are whole: build "
                         "the model without a tensor axis")
    return model.layers[0], bool(model.remat)


def _stage_fn(block: LlamaBlock, remat: bool):
    def apply_block(h, pending, pos, names, *weights):
        return torch.func.functional_call(
            block, dict(zip(names, weights)), (h, pos), {"pending": pending})

    def stage_fn(stage_params: Params, h: torch.Tensor) -> torch.Tensor:
        mb, length = h.shape[:2]
        pos = torch.arange(length, device=h.device)[None].expand(mb, length)
        names = list(stage_params)
        pending = None
        for j in range(next(iter(stage_params.values())).shape[0]):
            weights = [stage_params[n][j] for n in names]
            if remat and torch.is_grad_enabled():
                h, pending = torch.utils.checkpoint.checkpoint(
                    apply_block, h, pending, pos, names, *weights,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                h, pending = apply_block(h, pending, pos, names, *weights)
        # The stage hands its residual on whole (x + delta rounded to the
        # model's dtype: the fused norm's own sum).
        return h + pending

    return stage_fn


def staged_llama_forward(model: Llama, params: Mapping[str, torch.Tensor],
                         input_ids: torch.Tensor, *, mesh: Mesh,
                         n_microbatches: int,
                         n_virtual: int = 1,
                         stats: Optional[dict] = None) -> torch.Tensor:
    """The fp32 logits ``model`` gives on the unstaged params (the same
    block code), with the block stack pipelined over ``mesh``'s pipeline
    axis. ``params`` are the staged tree, its stages whole or this
    rank's; ``input_ids`` this rank's rows (its batch position's, the
    reference's rows on ``data``). ``n_virtual > 1`` selects the
    interleaved schedule."""
    x = F.embedding(input_ids, params["tok_embed.weight"]).to(model.dtype)
    block, remat = _block_for(model)
    stages = {k[len(STAGES):]: v for k, v in params.items()
              if k.startswith(STAGES)}
    if n_virtual > 1:
        x = spmd_pipeline_interleaved(
            _stage_fn(block, remat), stages, x, mesh=mesh,
            n_microbatches=n_microbatches, n_virtual=n_virtual,
            stats=stats)
    else:
        x = spmd_pipeline(_stage_fn(block, remat), stages, x, mesh=mesh,
                          n_microbatches=n_microbatches, stats=stats)
    x = torch.func.functional_call(
        model.final_norm, {"scale": params["final_norm.scale"]}, (x,))
    return F.linear(x.float(), params["lm_head.weight"].float())


def pipeline_state_shardings(mesh: Mesh, params: Mapping[str, Any],
                             n_virtual: int = 1) -> Dict[str, Sharding]:
    """``stages`` over the pipeline axis (its device dim: 0, or 1 for
    the interleaved ``[v, n, ...]`` layout); the embedding, final norm
    and head replicated. The moments mirror their params by name."""
    stage = Sharding(mesh, (PIPELINE_AXIS,) if n_virtual == 1
                     else (None, PIPELINE_AXIS))
    return {k: stage if k.startswith(STAGES) else Sharding(mesh, ())
            for k in params}


def check_pipeline_mesh(mesh: Mesh, model: nn.Module, what: str) -> None:
    """Raise where the pipeline trainer cannot run ``model`` on ``mesh``:
    an unported model axis (it runs the batch axes, seq and pipeline; an
    ``expert`` axis beside the stages is ROADMAP A18's pipeline item,
    with tensor), or a model that is not a dense Llama."""
    check_batch_axes(mesh, what, model, pipeline_ok=True)
    if mesh.shape["expert"] > 1:
        raise NotImplementedError(
            f"{what}: expert with pipeline is not ported (ROADMAP A18); "
            f"the pipeline trainer runs dcn_data, data, fsdp, seq and "
            f"pipeline")
    if not isinstance(model, Llama):
        raise ValueError(f"{what}: the pipeline trainer stages a Llama's "
                         f"blocks, not a {type(model).__name__}")
    _block_for(model)


def create_pipeline_lm_state(model: Llama, tx: GradientTransformation,
                             params: Mapping[str, torch.Tensor], mesh: Mesh,
                             n_stages: Optional[int] = None,
                             n_virtual: int = 1
                             ) -> Tuple[PipelineLMState,
                                        Dict[str, Sharding]]:
    """``(state, shardings)`` over ``params`` (a whole Llama's port
    params, e.g. ``models.convert.init_params`` of a
    ``param_dtype="float32"`` model, or params carried across from the
    reference), partitioned into ``n_stages · n_virtual`` stages placed
    cyclically (device d holds stages ``{q·n + d}``) and cut to this
    rank's. ``n_stages`` defaults to the mesh's pipeline axis."""
    n = mesh.shape[PIPELINE_AXIS]
    n_stages = n_stages or n
    if n_stages != n:
        raise ValueError(f"n_stages {n_stages} != mesh pipeline axis {n}")
    check_pipeline_mesh(mesh, model, "create_pipeline_lm_state")
    staged = partition_llama_params(params, n_stages * n_virtual)
    stages = {k: v for k, v in staged.items() if k.startswith(STAGES)}
    if n_virtual > 1:
        stages = interleave_stage_params(stages, n)
    staged.update(stage_piece(stages, mesh, n_virtual))
    leaves = {k: v.detach().requires_grad_(True) for k, v in staged.items()}
    shardings = pipeline_state_shardings(mesh, leaves, n_virtual)
    return PipelineLMState(step=0, params=leaves, opt_state=tx.init(leaves),
                           model=model, tx=tx, shardings=shardings), shardings


def make_pipeline_lm_train_step(mesh: Mesh, model: Llama, *,
                                n_microbatches: int = 4,
                                objective: str = "causal",
                                n_virtual: int = 1,
                                stats: Optional[dict] = None):
    """The ``pipeline=N`` trainer's step for a
    :func:`create_pipeline_lm_state` state built with the same
    ``n_virtual``: each rank calls it with its rows of the global batch;
    the state is updated in place and returned. Metrics: ``loss``,
    ``accuracy`` and ``grad_norm`` of the global batch, device
    scalars."""
    loss_fn = LOSSES[objective]
    check_pipeline_mesh(mesh, model, "make_pipeline_lm_train_step")

    def step(state: PipelineLMState, batch: Batch):
        params = state.params
        batch = place_batch(batch, next(iter(params.values())).device)
        total_w = torch.clamp_min(collectives.global_sum(
            lm_token_weight(batch, objective), mesh), 1.0)
        logits = staged_llama_forward(
            model, params, batch["input_ids"], mesh=mesh,
            n_microbatches=n_microbatches, n_virtual=n_virtual, stats=stats)
        loss, acc = loss_fn(logits, batch, total_w)
        names = list(params)
        got = torch.autograd.grad(loss, [params[k] for k in names])
        grads = {k: collectives.all_reduce_sum(g, mesh)
                 for k, g in zip(names, got)}
        with norm_over(collectives.norm_fn(state.shardings, mesh)):
            metrics = {"loss": collectives.global_sum(loss, mesh),
                       "accuracy": collectives.global_sum(acc, mesh),
                       "grad_norm": global_norm(grads)}
            state.opt_state = optimizer_step(state.tx, state.opt_state,
                                             params, grads)
        state.step += 1
        return state, metrics

    return step
