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

"""Flax's layers in PyTorch, shared by the port's vision and encoder
families (ResNet, Inception, VGG/AlexNet, ViT, BERT).

Every module keeps fp32 master params, as Flax does, and casts each to
the module's compute dtype at the op (Flax's ``promote_dtype``). A bias
is added after the product, in the compute dtype, as Flax adds it: the
product is rounded once, then the sum.

Names follow the Flax tree (models/convert.py maps ``weight`` ↔
``kernel``): :class:`Dense` and :class:`Conv` hold ``weight`` (``[out,
in]``, OIHW) and ``bias``; :class:`Embed` holds ``embedding``;
:class:`LayerNorm` holds ``scale`` and ``bias``.

Images are NCHW views of NHWC (channels-last) memory. Flax's ``SAME``
is asymmetric where the total padding is odd (the odd pixel after the
input), so odd totals are padded explicitly (zeros for convs and the
average pool, −inf for the max pool), never by PyTorch's symmetric
``padding``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

Padding = Tuple[Tuple[int, int], Tuple[int, int]]


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME``: output ceil(size / stride), the odd pixel of the
    total padding after the input."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad2d(x: torch.Tensor, padding: Padding, value: float = 0.0):
    """Pad [N, C, H, W] by ((top, bottom), (left, right)), keeping
    channels-last memory."""
    (top, bottom), (left, right) = padding
    return F.pad(x, (left, right, top, bottom), value=value)


def _split_padding(padding: Padding):
    """A symmetric padding the op takes itself, or None when x must be
    padded first."""
    (top, bottom), (left, right) = padding
    if top == bottom and left == right:
        return (top, left)
    return None


def _resolve(x: torch.Tensor, padding, kernel: Tuple[int, int],
             strides: Tuple[int, int], value: float = 0.0):
    """``(x, symmetric padding)`` for ``padding`` "SAME", "VALID" or
    ((top, bottom), (left, right)): x padded first where the padding is
    not symmetric."""
    if padding == "VALID":
        return x, (0, 0)
    if padding == "SAME":
        padding = (same_padding(x.shape[2], kernel[0], strides[0]),
                   same_padding(x.shape[3], kernel[1], strides[1]))
    symmetric = _split_padding(padding)
    if symmetric is None:
        return _pad2d(x, padding, value), (0, 0)
    return x, symmetric


class Conv(nn.Module):
    """``nn.Conv``: an fp32 OIHW kernel (and bias, with ``bias=True``),
    cast to x's dtype at the op. ``padding`` is "SAME", "VALID" or
    ((top, bottom), (left, right))."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int], strides: Tuple[int, int] = (1, 1),
                 padding="SAME", bias: bool = False, device=None):
        super().__init__()
        self.strides = tuple(strides)
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(
            features, in_features, *kernel, dtype=torch.float32,
            device=device))
        self.bias = (nn.Parameter(torch.empty(features, dtype=torch.float32,
                                              device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, symmetric = _resolve(x, self.padding, self.weight.shape[2:],
                                self.strides)
        w = self.weight.to(dtype=x.dtype, memory_format=torch.channels_last)
        y = F.conv2d(x, w, stride=self.strides, padding=symmetric)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)[:, None, None]
        return y


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: str = "VALID") -> torch.Tensor:
    """``nn.max_pool(x, (w, w), (s, s), padding)``: −inf pads."""
    x, symmetric = _resolve(x, padding, (window, window), (stride, stride),
                            value=float("-inf"))
    return F.max_pool2d(x, window, stride, padding=symmetric)


def max_pool_same(x: torch.Tensor, window: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """``nn.max_pool(x, (w, w), (s, s), padding="SAME")``."""
    return max_pool(x, window, stride, "SAME")


def avg_pool(x: torch.Tensor, window: int, stride: int,
             padding: str = "VALID") -> torch.Tensor:
    """``nn.avg_pool(x, (w, w), (s, s), padding)``: Flax divides every
    window's sum by the full window size, padded cells included."""
    x, symmetric = _resolve(x, padding, (window, window), (stride, stride))
    return F.avg_pool2d(x, window, stride, padding=symmetric,
                        count_include_pad=True)


def nhwc_input(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An NHWC image batch as the NCHW view of its channels-last memory,
    in ``dtype``."""
    return x.to(dtype).permute(0, 3, 1, 2)


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=(1, 2))`` of the NHWC batch: taken in fp32 and
    rounded to x's dtype, as ``jnp.mean`` on bf16 does."""
    return x.float().mean((2, 3)).to(x.dtype)


class Dense(nn.Module):
    """``nn.Dense``: an fp32 ``[out, in]`` weight and bias, x and both
    cast to ``dtype`` at the op."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype,
                 bias: bool = True, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_features, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.empty(features, dtype=torch.float32,
                                              device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Embed(nn.Module):
    """``nn.Embed``: an fp32 ``[num, features]`` table, gathered then
    cast to ``dtype`` (the rows of Flax's cast-then-gather)."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(
            num_embeddings, features, dtype=torch.float32, device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.embedding).to(self.dtype)

    def attend(self, query: torch.Tensor) -> torch.Tensor:
        """``Embed.attend``: the query and the table both promoted to
        ``dtype``, their product in it."""
        return F.linear(query.to(self.dtype),
                        self.embedding.to(self.dtype))


class LayerNorm(nn.Module):
    """``nn.LayerNorm`` over the last axis: ε = 1e-6; statistics in
    fp32 by E[x²] − E[x]² clamped at 0; (x − mean)·(rsqrt(var + ε)·
    scale) + bias in fp32, cast to ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype,
                 epsilon: float = 1e-6, device=None):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.empty(features, dtype=torch.float32,
                                              device=device))
        self.bias = nn.Parameter(torch.empty(features, dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp(xf.square().mean(-1, keepdim=True)
                          - mean.square(), min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``nn.gelu(x, approximate=True)``: the tanh form."""
    return F.gelu(x, approximate="tanh")


def apply(model: nn.Module, params: Dict[str, torch.Tensor],
          batch_stats: Optional[Dict[str, torch.Tensor]], x: torch.Tensor,
          train: bool = True) -> torch.Tensor:
    """``model(x, train)`` with ``params`` as its weights and
    ``batch_stats`` as its BN running statistics (empty or None for a
    model without BN) — the port's ``model.apply({"params": ...,
    "batch_stats": ...}, x, train=...)``. A training forward updates
    ``batch_stats`` in place."""
    return torch.func.functional_call(model, {**params, **(batch_stats or {})},
                                      (x,), {"train": train}, strict=True)
