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

"""Held-out evaluation of a vision model over a stream of batches.

Port of ``evaluate_vision`` in ``kubeflow_tpu/training/evaluate.py``
(the LM half comes with the LM-training slice). Sums, not means of
means, so the numbers are exact over ragged batches; they accumulate as
device tensors and reach the host once, at the end.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from kubeflow_tpu_torch.models.resnet import apply

Batch = Dict[str, torch.Tensor]


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
    totals = None
    n_batches = 0
    for batch in batches:
        logits = apply(model, variables["params"], variables["batch_stats"],
                       batch["inputs"], train=False)
        labels = batch["labels"].long()
        sums = torch.stack([
            F.cross_entropy(logits.float(), labels, reduction="sum"),
            torch.tensor(float(labels.shape[0]), device=logits.device),
            (logits.argmax(-1) == labels).float().sum()])
        totals = sums if totals is None else totals + sums
        n_batches += 1
        if max_batches is not None and n_batches >= max_batches:
            break
    if n_batches == 0:
        raise ValueError("evaluation stream produced no examples")
    total_ce, total_n, total_correct = totals.tolist()
    return {
        "loss": total_ce / total_n,
        "accuracy": total_correct / total_n,
        "examples": total_n,
        "batches": float(n_batches),
    }
