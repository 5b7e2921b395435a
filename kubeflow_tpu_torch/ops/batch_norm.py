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

"""Batch normalization with ghost-batch statistics, in PyTorch.

Port of ``kubeflow_tpu/ops/batch_norm.py``. Training statistics come
from the first ``stat_rows`` images of the batch (0 = all, exact batch
norm); every image is normalized with them. The training forward is
:func:`fused_bn_train_forward` (ops/bn_fused.py): on the GPU, the CUDA
kernel. Evaluation uses the running statistics, in plain PyTorch.

Semantics are the reference's, not ``torch.nn.BatchNorm2d``'s:
variance by E[x²] − mean² clamped at 0, the running update
``ra = momentum·ra + (1 − momentum)·stat`` with the *biased* variance,
normalization as (x − mean)·(rsqrt(var + eps)·scale) + bias in fp32,
output cast to the module dtype. ``F.batch_norm`` appears nowhere.

Parameters ``scale`` and ``bias`` are fp32; the running ``mean`` and
``var`` are fp32 buffers, which the port's models pass as a separate
``batch_stats`` dict (the Flax collection of that name). Unlike the
reference's functional collection, a training forward updates those
tensors in place.

Sync BN. Inside :func:`sync_batch_norm` (the vision trainer's meshed
step enters it) every training forward takes
:func:`~kubeflow_tpu_torch.ops.bn_fused.sync_bn_train_forward`: the
statistics of the global batch, as the reference's BN has them on a
batch-sharded mesh (XLA reduces them across devices). With
``stat_rows > 0`` they are those of the global batch's first
``stat_rows`` images, as the reference computes ``x[:stat_rows]`` of
the global array: the ranks holding those images contribute their rows,
the others none.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator, NamedTuple

import torch
import torch.nn as nn

from kubeflow_tpu_torch.ops.bn_fused import (
    fused_bn_train_forward,
    sync_bn_train_forward,
)
from kubeflow_tpu_torch.utils.device import torch_dtype

TrainForward = Callable[..., tuple]


class SyncGroup(NamedTuple):
    """The batch's split over ranks: ``reduce(t)`` sums a tensor in place
    over them; this rank holds global images [index·n, (index + 1)·n) of
    ``size``·n, n its own count."""

    reduce: Callable[[torch.Tensor], torch.Tensor]
    index: int
    size: int


_SYNC: contextvars.ContextVar = contextvars.ContextVar("sync_bn",
                                                       default=None)


@contextlib.contextmanager
def sync_batch_norm(group: SyncGroup) -> Iterator[None]:
    """Every ``GhostBatchNorm`` training forward in the block takes the
    statistics of the batch over ``group``'s ranks (sync BN)."""
    token = _SYNC.set(group)
    try:
        yield
    finally:
        _SYNC.reset(token)


def rows_view(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] in channels-last memory (or [N, C]) as the
    row-major [N·H·W, C] view the kernel reads. Raises rather than
    copies when x is not laid out so: a copy would double the layer's
    traffic unseen."""
    if x.dim() == 4:
        nhwc = x.permute(0, 2, 3, 1)
        if not nhwc.is_contiguous():
            raise ValueError(
                f"GhostBatchNorm input {tuple(x.shape)} is not "
                f"channels-last contiguous (strides {x.stride()})")
        return nhwc.view(-1, x.shape[1])
    if x.dim() == 2 and x.is_contiguous():
        return x
    raise ValueError(f"GhostBatchNorm takes channels-last [N, C, H, W] or "
                     f"contiguous [N, C]; got {tuple(x.shape)} strides "
                     f"{x.stride()}")


class GhostBatchNorm(nn.Module):
    """``GhostBatchNorm`` of the reference over the channel dimension.

    ``forward(x, train)``: x is [N, C, H, W] in channels-last memory (or
    [N, C]) of the module dtype. ``train_forward`` replaces the training
    forward (the plain version, to compare against the kernel).
    """

    def __init__(self, features: int, *, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype="bfloat16", stat_rows: int = 0,
                 scale_init: float = 1.0,
                 train_forward: TrainForward = fused_bn_train_forward,
                 device=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = torch_dtype(dtype)
        self.stat_rows = stat_rows
        self.scale_init = scale_init
        self.train_forward = train_forward
        self.scale = nn.Parameter(torch.full((features,), scale_init,
                                             dtype=torch.float32,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32,
                                             device=device))
        self.register_buffer("mean", torch.zeros(features,
                                                 dtype=torch.float32,
                                                 device=device))
        self.register_buffer("var", torch.ones(features, dtype=torch.float32,
                                               device=device))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if x.dtype != self.dtype:
            raise ValueError(f"GhostBatchNorm({self.dtype}) got {x.dtype}")
        rows = rows_view(x)
        sync = _SYNC.get() if train else None
        if sync is not None:
            y, mean, var = self._sync_forward(rows, x.shape[0], sync)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        elif train:
            n = x.shape[0]
            stat_rows = None
            if 0 < self.stat_rows < n:
                # The leading images are the leading rows of the view.
                stat_rows = self.stat_rows * (rows.shape[0] // n)
            y, mean, var = self.train_forward(
                rows, self.scale, self.bias, eps=self.epsilon,
                stat_rows=stat_rows)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            # Running statistics, the reference's op order, in fp32.
            mul = torch.rsqrt(self.var + self.epsilon) * self.scale
            y = ((rows.float() - self.mean) * mul + self.bias).to(self.dtype)
        if x.dim() == 2:
            return y
        n, c, h, w = x.shape
        return y.view(n, h, w, c).permute(0, 3, 1, 2)

    def _sync_forward(self, rows: torch.Tensor, n: int, sync: SyncGroup):
        """The sync route: statistics over the global batch's first
        ``stat_rows`` images (all when 0), whichever ranks hold them."""
        per_image = rows.shape[0] // n
        total = n * sync.size
        stat_images = self.stat_rows if 0 < self.stat_rows < total else total
        mine = min(max(stat_images - sync.index * n, 0), n)
        return sync_bn_train_forward(
            rows, self.scale, self.bias, eps=self.epsilon,
            stat_rows=None if mine == n else mine * per_image,
            count=stat_images * per_image, reduce=sync.reduce)
