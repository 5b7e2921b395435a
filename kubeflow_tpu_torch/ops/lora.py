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


"""LoRA: low-rank adapters for parameter-efficient fine-tuning.

The port's ``kubeflow_tpu/ops/lora.py``. ``y = x·W + (x·A)·B·(α/r)``:
the base weight W stays frozen and only the rank-r adapters train. A is
``[in, r]`` (normal(0.02), fp32) and B ``[r, out]`` (zeros, fp32), in
the reference's layout, so step 0 is exactly the base model. Both are
cast to the op's dtype at the op, as the reference casts them
(``ops/lora.py:100-103``), and the full-size product A·B is never
formed while training. :func:`merge_lora` folds trained adapters into
the base weights for serving.

There is no kernel here: the adapter's two skinny products are plain
``torch.matmul``, as the reference leaves them to XLA.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from kubeflow_tpu_torch.utils.device import resolve_device

#: The suffixes of an adapter's two parameters.
LORA_SUFFIXES = (".lora_a", ".lora_b")


def is_lora_name(name: str) -> bool:
    """True for an adapter parameter (``...q_proj.lora_a``)."""
    return name.endswith(LORA_SUFFIXES)


class LoRALinear(nn.Linear):
    """A bias-free ``nn.Linear`` with a low-rank adapter branch.

    ``weight`` is the base ``[out, in]`` as in any ``nn.Linear`` (the
    same name and path as the plain layer, so params interchange);
    ``lora_a [in, r]`` and ``lora_b [r, out]`` are the adapters, fp32.
    ``forward(x)`` computes in ``x``'s dtype, each weight cast to it at
    the op."""

    def __init__(self, in_features: int, out_features: int, rank: int,
                 alpha: float = 16.0, dtype=None, device=None):
        super().__init__(in_features, out_features, bias=False, dtype=dtype,
                         device=device)
        if rank <= 0:
            raise ValueError(f"LoRA rank must be > 0, got {rank}")
        self.rank = rank
        self.alpha = alpha
        self.lora_a = nn.Parameter(torch.empty(
            in_features, rank, dtype=torch.float32, device=device))
        self.lora_b = nn.Parameter(torch.empty(
            rank, out_features, dtype=torch.float32, device=device))

    def delta(self, x: torch.Tensor) -> torch.Tensor:
        """``(x·A)·B·(α/r)`` in x's dtype, the scale rounded to it first
        as the reference's ``jnp.asarray(scale, dtype)``."""
        dtype = x.dtype
        scale = float(torch.tensor(self.alpha / self.rank, dtype=dtype))
        return ((x @ self.lora_a.to(dtype)) @ self.lora_b.to(dtype)) * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype)) + self.delta(x)


def init_lora(config: nn.Module, seed: int = 0,
              device=None) -> Dict[str, torch.Tensor]:
    """The adapters of ``config`` drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``: every ``lora_a``
    normal(0.02), every ``lora_b`` zeros, fp32, keyed by parameter name.
    (The numbers differ from ``jax.random``'s; to compare with the
    reference, carry its ``lora`` collection across instead.)"""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for name, template in config.named_parameters():
        if not is_lora_name(name):
            continue
        t = torch.zeros(template.shape, dtype=torch.float32, device=device)
        if name.endswith(".lora_a"):
            t.normal_(0.0, 0.02, generator=gen)
        out[name] = t
    return out


@torch.no_grad()
def merge_lora(params: Mapping[str, torch.Tensor],
               lora: Mapping[str, torch.Tensor],
               alpha: float) -> Dict[str, torch.Tensor]:
    """Fold trained adapters into the base weights: ``W += A·B·(α/r)``.

    ``alpha`` is required and must be the ``lora_alpha`` the model was
    trained with. ``lora`` holds ``<layer>.lora_a`` / ``<layer>.lora_b``
    for each adapted ``<layer>.weight`` of ``params``. Each merged
    weight is W widened to fp32 plus the fp32 product, cast back to W's
    dtype once; in the port's ``[out, in]`` layout the product is
    ``(A·B)ᵀ``. Returns a new dict (unmerged weights shared, not
    copied) with the same names and dtypes as ``params``."""
    out = dict(params)
    for name, a in lora.items():
        if not name.endswith(".lora_a"):
            continue
        layer = name[:-len(".lora_a")]
        b = lora[f"{layer}.lora_b"]
        kernel = params[f"{layer}.weight"]
        a32, b32 = a.float(), b.float()
        merged = kernel.float() + (a32 @ b32 * (alpha / a.shape[1])).T
        out[f"{layer}.weight"] = merged.to(kernel.dtype)
    return out
