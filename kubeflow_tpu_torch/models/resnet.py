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

"""ResNet family (v1.5) in PyTorch.

Port of ``kubeflow_tpu/models/resnet.py``, the model of the ``tpu-cnn``
benchmark. Parameter names follow the Flax tree (``conv_init.weight`` ↔
``conv_init/kernel``, ``stage1_block1.bn1.scale`` ↔
``stage1_block1/bn1/scale``; models/convert.py maps one onto the
other).

- Layout: the public input is NHWC, as the reference's. Inside, every
  activation is NCHW in channels-last memory, so each BN input is a free
  [N·H·W, C] view for the kernel.
- Dtypes: params are fp32 masters, as Flax keeps them; each conv casts
  its kernel to the model dtype (bf16) at the op. The spatial mean is
  taken in fp32 and rounded to the model dtype, as ``jnp.mean`` on bf16
  does; the head is fp32 over an fp32 cast.
- Padding: Flax's ``SAME`` is asymmetric where the total is odd —
  (0, 1) for a 3×3/s2 conv or the 3×3/s2 max pool on an even size,
  (2, 3) for the 7×7/s2 stem on 224 — so odd totals are padded
  explicitly (models/layers.py, shared with the other vision models).
- A block has a projection shortcut when its stride is not 1 or its
  width changes: the shapes at which Flax's ``residual.shape !=
  y.shape`` holds for every input larger than 1×1 at a strided block.

Modules are templates built on the meta device; weights travel as a
``params`` dict and the BN running statistics as a ``batch_stats`` dict,
applied with :func:`~kubeflow_tpu_torch.models.layers.apply`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from kubeflow_tpu_torch.models.layers import Conv, max_pool_same
from kubeflow_tpu_torch.models.registry import ModelEntry, register_model
from kubeflow_tpu_torch.ops.batch_norm import GhostBatchNorm, TrainForward
from kubeflow_tpu_torch.ops.bn_fused import fused_bn_train_forward
from kubeflow_tpu_torch.utils.device import torch_dtype

class BottleneckBlock(nn.Module):
    """1x1 → 3x3 → 1x1 bottleneck with projection shortcut (v1.5: the
    stride is on the 3x3)."""

    def __init__(self, in_features: int, filters: int,
                 strides: Tuple[int, int], norm, device=None):
        super().__init__()
        out = filters * 4
        self.conv1 = Conv(in_features, filters, (1, 1), device=device)
        self.bn1 = norm(filters)
        self.conv2 = Conv(filters, filters, (3, 3), strides, device=device)
        self.bn2 = norm(filters)
        self.conv3 = Conv(filters, out, (1, 1), device=device)
        # Zero-init the last BN scale: residual branches start as
        # identity, the standard large-batch trick.
        self.bn3 = norm(out, scale_init=0.0)
        self.has_proj = tuple(strides) != (1, 1) or in_features != out
        if self.has_proj:
            self.conv_proj = Conv(in_features, out, (1, 1), strides,
                                  device=device)
            self.bn_proj = norm(out)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        residual = x
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        if self.has_proj:
            residual = self.bn_proj(self.conv_proj(residual), train)
        return F.relu(residual + y)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """[B, H, W, C] → [B, H/b, W/b, b²·C]; channel order (a, b, c) with
    a/b the within-block spatial offsets (the order
    :func:`stem_kernel_to_s2d` assumes)."""
    bsz, h, w, c = x.shape
    x = x.reshape(bsz, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(bsz, h // block, w // block, block * block * c)


def stem_kernel_to_s2d(w7: torch.Tensor) -> torch.Tensor:
    """A (7, 7, C, O) HWIO stride-2 stem kernel as the equivalent
    (4, 4, 4C, O) stride-1 kernel over space-to-depth input (the
    derivation is in ``kubeflow_tpu/models/resnet.py``): zero-pad to
    8×8, then fold each 2×2 tap block into channels."""
    k, _, c, o = w7.shape
    if k != 7:
        raise ValueError(f"stem kernel {tuple(w7.shape)} is not 7x7")
    w8 = F.pad(w7, (0, 0, 0, 0, 0, 1, 0, 1))
    w = w8.reshape(4, 2, 4, 2, c, o).permute(0, 2, 1, 3, 4, 5)
    return w.reshape(4, 4, 4 * c, o)


class ResNet(nn.Module):
    """ResNet v1.5: ``forward(x, train)`` on an NHWC image batch → fp32
    logits [B, num_classes]. Built on the meta device unless ``device``
    is given.

    ``stem``: "conv7" (7×7/s2) or "s2d" (the space-to-depth
    reparametrization: a 4×4/s1 conv over 12 channels at half size).
    ``bn_stat_rows``: training BN statistics over the first N images
    (0 = all). ``norm_fn`` replaces every BN layer's training forward
    (the plain version, to compare against the kernel).
    """

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 width: int = 64, dtype="bfloat16", stem: str = "conv7",
                 bn_stat_rows: int = 0,
                 norm_fn: Optional[TrainForward] = None, device="meta"):
        super().__init__()
        if stem not in ("conv7", "s2d"):
            raise ValueError(
                f"unknown stem {stem!r}; expected 'conv7' or 's2d'")
        self.stage_sizes = tuple(stage_sizes)
        self.num_classes = num_classes
        self.width = width
        self.dtype = torch_dtype(dtype)
        self.stem = stem
        self.bn_stat_rows = bn_stat_rows

        def norm(features, scale_init=1.0):
            return GhostBatchNorm(
                features, momentum=0.9, epsilon=1e-5, dtype=self.dtype,
                stat_rows=bn_stat_rows, scale_init=scale_init,
                train_forward=norm_fn or fused_bn_train_forward,
                device=device)

        if stem == "s2d":
            self.conv_init = Conv(12, width, (4, 4), padding=((1, 2), (1, 2)),
                                  device=device)
        else:
            self.conv_init = Conv(3, width, (7, 7), (2, 2), device=device)
        self.bn_init = norm(width)
        self.block_names = []
        features = width
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                strides = (2, 2) if stage > 0 and block == 0 else (1, 1)
                name = f"stage{stage + 1}_block{block + 1}"
                filters = width * 2 ** stage
                self.add_module(name, BottleneckBlock(
                    features, filters, strides, norm, device=device))
                self.block_names.append(name)
                features = filters * 4
        self.head = nn.Linear(features, num_classes, dtype=torch.float32,
                              device=device)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.stem == "s2d":
            x = space_to_depth(x)
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        x = F.relu(self.bn_init(self.conv_init(x), train))
        x = max_pool_same(x, 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        x = x.float().mean((2, 3)).to(self.dtype)
        return self.head(x.float())


def resnet50(num_classes: int = 1000, dtype="bfloat16", stem: str = "conv7",
             bn_stat_rows: int = 0, **kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), num_classes=num_classes,
                  dtype=dtype, stem=stem, bn_stat_rows=bn_stat_rows, **kw)


def resnet101(num_classes: int = 1000, dtype="bfloat16",
              bn_stat_rows: int = 0, **kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), num_classes=num_classes,
                  dtype=dtype, bn_stat_rows=bn_stat_rows, **kw)


def resnet18ish(num_classes: int = 10, dtype="bfloat16",
                bn_stat_rows: int = 0, **kw) -> ResNet:
    """Small bottleneck net for tests/CI (not a literal ResNet-18)."""
    return ResNet(stage_sizes=(1, 1, 1, 1), num_classes=num_classes,
                  width=16, dtype=dtype, bn_stat_rows=bn_stat_rows, **kw)


register_model(ModelEntry("resnet50", "vision", resnet50,
                          ((224, 224, 3), "bfloat16"), 1000))
register_model(ModelEntry("resnet101", "vision", resnet101,
                          ((224, 224, 3), "bfloat16"), 1000))
register_model(ModelEntry("resnet-test", "vision", resnet18ish,
                          ((32, 32, 3), "bfloat16"), 10))
