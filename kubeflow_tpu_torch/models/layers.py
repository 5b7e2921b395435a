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

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from kubeflow_tpu_torch.parallel.collectives import (
    copy_to_tensor,
    reduce_from_tensor,
)
from kubeflow_tpu_torch.parallel.mesh import tensor_axis

Padding = Tuple[Tuple[int, int], Tuple[int, int]]
#: A param's logical axes, as the reference's ``nn.with_partitioning``
#: names them (``("embed", "mlp")``), or None where it names none.
LogicalAxes = Optional[Tuple[Optional[str], ...]]


def logical_axes_by_suffix(table: Sequence[Tuple[str, LogicalAxes]],
                           key: str) -> LogicalAxes:
    """The axes of the first ``(suffix, axes)`` of ``table`` whose suffix
    ends the Flax key ``key`` (a leading ``params/`` or ``lora/``
    collection is dropped), or None."""
    key = key.split("/", 1)[1] if key.startswith(("params/", "lora/")) else key
    for suffix, axes in table:
        if key == suffix or key.endswith("/" + suffix):
            return axes
    return None


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


def _part(n: int, parts: int) -> int:
    """A rank's share of ``n`` over ``parts`` ranks; an uneven split
    raises, as the reference's sharded init does."""
    if n % parts:
        raise ValueError(f"{n} does not split over tensor={parts}")
    return n // parts


class Dense(nn.Module):
    """``nn.Dense``: an fp32 ``[out, in]`` weight and bias, x and both
    cast to ``dtype`` at the op.

    On a ``mesh`` with a tensor axis of T > 1, ``split`` makes it one of
    Megatron's pair. ``"column"``: this rank's ``out / T`` rows of the
    weight; x is the replicated input, which the caller passes through
    :func:`copy_to_tensor` once for every column piece that reads it
    (its gradient summed over the tensor line), and the output is the
    rank's columns. ``"row"``: this rank's ``in / T`` columns; x is the
    rank's slice of the input features, and the partial products, taken
    in fp32 on the compute dtype's values, are summed over the tensor
    line in fp32 (:func:`reduce_from_tensor`) and rounded once, as the
    whole product's sum is. The bias carries no partitioning in the
    reference, so its rule table keeps it whole on every rank: a column
    piece adds its own slice of it (the slice's gradient summed over the
    line, as every rank holds the whole bias), a row piece adds it once,
    after the sum."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype,
                 bias: bool = True, device=None, mesh: Any = None,
                 split: Optional[str] = None):
        super().__init__()
        self.dtype = dtype
        self.split = split
        if split not in (None, "column", "row"):
            raise ValueError(f"split is column, row or None, not {split!r}")
        self.mesh, tensor, rank = tensor_axis(mesh if split else None)
        whole = features
        if split == "column":
            features = _part(features, tensor)
        elif split == "row":
            in_features = _part(in_features, tensor)
        #: This rank's first output column of the whole layer.
        self.start = rank * features if split == "column" else 0
        self.weight = nn.Parameter(torch.empty(
            features, in_features, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.empty(whole, dtype=torch.float32,
                                              device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias
        if self.mesh is not None and self.split == "row":
            # fp32 partials on the compute dtype's values, added over the
            # line and rounded once: one rank's fp32 sum rounded once.
            partial = F.linear(x.to(self.dtype).float(),
                               self.weight.to(self.dtype).float())
            y = reduce_from_tensor(partial, self.mesh).to(self.dtype)
        else:
            y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
            if self.mesh is not None and bias is not None:
                bias = copy_to_tensor(bias, self.mesh)[
                    self.start:self.start + y.shape[-1]]
        if bias is not None:
            y = y + bias.to(self.dtype)
        return y


class Embed(nn.Module):
    """``nn.Embed``: an fp32 ``[num, features]`` table, gathered then
    cast to ``dtype`` (the rows of Flax's cast-then-gather).

    On a ``mesh`` with a tensor axis of T > 1 the table is split on its
    rows (the reference's ``("vocab", "embed")``): this rank holds rows
    ``[start, start + num / T)``; a lookup gives its rows for the ids in
    that range and zeros for the others, summed over the tensor line
    (bitwise the whole table's lookup), and :meth:`attend` gives the
    rank's columns of the logits."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype, device=None, mesh: Any = None):
        super().__init__()
        self.dtype = dtype
        self.mesh, tensor, rank = tensor_axis(mesh)
        num_embeddings = _part(num_embeddings, tensor)
        #: This rank's first row of the whole table.
        self.start = rank * num_embeddings
        self.embedding = nn.Parameter(torch.empty(
            num_embeddings, features, dtype=torch.float32, device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return F.embedding(ids.long(), self.embedding).to(self.dtype)
        local = ids.long() - self.start
        mine = (local >= 0) & (local < self.embedding.shape[0])
        rows = F.embedding(torch.where(mine, local, 0),
                           self.embedding).to(self.dtype)
        rows = torch.where(mine[..., None], rows, torch.zeros(
            (), dtype=rows.dtype, device=rows.device))
        return reduce_from_tensor(rows, self.mesh)

    def attend(self, query: torch.Tensor) -> torch.Tensor:
        """``Embed.attend``: the query and the table both promoted to
        ``dtype``, their product in it (on a tensor axis, this rank's
        columns; the query's gradient summed over the tensor line)."""
        return F.linear(copy_to_tensor(query, self.mesh).to(self.dtype),
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
