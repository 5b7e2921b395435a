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

"""Held-out evaluation: loss, perplexity and accuracy over a stream.

Port of ``kubeflow_tpu/training/evaluate.py``. Sums, not means of
means, so the numbers are exact over ragged batches; they accumulate as
device tensors and reach the host once, at the end. The LM half takes
the trainers' batches (causal or mlm) through the trainers' own
:func:`~kubeflow_tpu_torch.training.lm.lm_targets`, so train and eval
cannot disagree on batch conventions, and either a plain params dict or
a params + LoRA pair (a fine-tune evaluated unmerged).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from kubeflow_tpu_torch.models.layers import apply
from kubeflow_tpu_torch.training.data import place_batch
from kubeflow_tpu_torch.training.lm import (
    apply_lm,
    lm_targets,
    softmax_cross_entropy_with_integer_labels,
)

Batch = Dict[str, torch.Tensor]


def _accumulate(batches: Iterator[Any], step: Callable, max_batches):
    """Sum a per-batch tuple of device scalars over the stream (no host
    pull a batch: that would serialize the loop)."""
    totals = None
    n = 0
    for batch in batches:
        sums = step(batch)
        totals = sums if totals is None else tuple(
            a + b for a, b in zip(totals, sums))
        n += 1
        if max_batches is not None and n >= max_batches:
            break
    return totals, n


@torch.no_grad()
def evaluate_vision(
    model: nn.Module,
    variables: Dict[str, Dict[str, torch.Tensor]],
    batches: Iterator[Batch],
    *,
    max_batches: Optional[int] = None,
) -> Dict[str, float]:
    """Exact top-1 accuracy + mean cross entropy over an image stream.
    ``variables`` is ``{"params": ..., "batch_stats": ...}``; eval-mode
    BN normalizes with the running statistics. Batches are the trainer's
    ``{"inputs", "labels"}`` dicts."""
    def sums(batch):
        logits = apply(model, variables["params"],
                       variables.get("batch_stats"), batch["inputs"],
                       train=False)
        labels = batch["labels"].long()
        return (F.cross_entropy(logits.float(), labels, reduction="sum"),
                torch.tensor(float(labels.shape[0]), device=logits.device),
                (logits.argmax(-1) == labels).float().sum())

    totals, n_batches = _accumulate(batches, sums, max_batches)
    if n_batches == 0:
        raise ValueError("evaluation stream produced no examples")
    total_ce, total_n, total_correct = (float(t) for t in totals)
    return {
        "loss": total_ce / total_n,
        "accuracy": total_correct / total_n,
        "examples": total_n,
        "batches": float(n_batches),
    }


@torch.no_grad()
def _eval_sums(model: nn.Module, params: Dict[str, torch.Tensor],
               batch: Dict[str, Any], objective: str
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Σ weighted CE, Σ weights, Σ weighted correct) of one batch, as
    device scalars."""
    batch = place_batch(batch, next(iter(params.values())).device)
    logits = apply_lm(model, params, batch)
    logits, targets, weights = lm_targets(logits, batch, objective)
    ce = softmax_cross_entropy_with_integer_labels(logits, targets)
    correct = (logits.argmax(-1) == targets).float()
    return ((ce * weights).sum(), weights.sum(), (correct * weights).sum())


def evaluate_lm(model: nn.Module, variables: Dict[str, Dict[str,
                                                          torch.Tensor]],
                batches: Iterator[Any], *, objective: str = "causal",
                max_batches: Optional[int] = None) -> Dict[str, float]:
    """Exact aggregate metrics over ``batches`` (or the first
    ``max_batches``). ``variables`` is ``{"params": p}`` or ``{"params":
    p, "lora": l}`` for an unmerged fine-tune."""
    params = {**variables["params"], **variables.get("lora", {})}
    totals, n = _accumulate(
        batches, lambda b: _eval_sums(model, params, b, objective),
        max_batches)
    if n == 0:
        raise ValueError("evaluation stream produced no weighted tokens")
    total_ce, total_w, total_correct = (float(t) for t in totals)
    if total_w == 0:
        raise ValueError("evaluation stream produced no weighted tokens")
    loss = total_ce / total_w
    return {
        "loss": loss,
        "perplexity": math.exp(min(loss, 80.0)),  # overflow guard
        "accuracy": total_correct / total_w,
        "tokens": total_w,
        "batches": float(n),
    }
