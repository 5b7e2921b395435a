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


"""Small tree utilities shared by the trainers and benchmarks.

The port's copy of ``kubeflow_tpu/utils/trees.py``. A tree here is a
dict of tensors (nested dicts allowed), the port's form of a params
tree.
"""

from __future__ import annotations

from typing import Any

import torch


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating-point leaf to ``dtype``; leave integer and
    bool leaves (ids, step counters) untouched. A leaf already in
    ``dtype`` is returned as it is, not copied, so a bf16 tree cast to
    bf16 shares its tensors.

    Used by the LoRA trainer for its frozen base
    (training/finetune.py): each fp32 leaf can be dropped as soon as its
    cast exists, so casting a 7B tree never holds two copies of it."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree
