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

"""Inception-v3 in PyTorch.

Port of ``kubeflow_tpu/models/inception.py`` (299×299×3 NHWC input, the
reference's serving-demo model). Every conv is a :class:`ConvBN`: a
bias-free conv, a ``GhostBatchNorm`` with ε = 1e-3 and momentum 0.9
(whose training forward is the BN kernel on the card, at widths 32 …
448, many not multiples of 128), then relu. Pools and ``SAME`` convs
pad as Flax does (models/layers.py): the 3×3/s1 average pool counts the
padded cells, the max pools are ``VALID``. Branches are concatenated
over channels, as the reference's ``jnp.concatenate(axis=-1)``; every
activation stays an NCHW view of channels-last memory, so each BN input
is a free ``[N·H·W, C]`` view.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from kubeflow_tpu_torch.models.layers import (
    Conv,
    Dense,
    avg_pool,
    max_pool,
    nhwc_input,
    spatial_mean,
)
from kubeflow_tpu_torch.models.registry import ModelEntry, register_model
from kubeflow_tpu_torch.ops.batch_norm import GhostBatchNorm, TrainForward
from kubeflow_tpu_torch.ops.bn_fused import fused_bn_train_forward
from kubeflow_tpu_torch.utils.device import torch_dtype


class ConvBN(nn.Module):
    """conv → BN → relu (inception's BasicConv2d)."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int], strides=(1, 1), padding="SAME", *,
                 cfg: dict):
        super().__init__()
        self.conv = Conv(in_features, features, kernel, strides, padding,
                         device=cfg["device"])
        self.bn = GhostBatchNorm(
            features, momentum=0.9, epsilon=1e-3, dtype=cfg["dtype"],
            stat_rows=cfg["bn_stat_rows"], train_forward=cfg["norm_fn"],
            device=cfg["device"])

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x), train))


def _avg3(x: torch.Tensor) -> torch.Tensor:
    return avg_pool(x, 3, 1, "SAME")


def _cat(*xs: torch.Tensor) -> torch.Tensor:
    """Concatenate over channels, keeping channels-last memory."""
    return torch.cat(xs, dim=1).contiguous(memory_format=torch.channels_last)


class InceptionA(nn.Module):
    def __init__(self, c_in: int, pool_features: int, cfg: dict):
        super().__init__()
        self.b1x1 = ConvBN(c_in, 64, (1, 1), cfg=cfg)
        self.b5x5_1 = ConvBN(c_in, 48, (1, 1), cfg=cfg)
        self.b5x5_2 = ConvBN(48, 64, (5, 5), cfg=cfg)
        self.b3x3dbl_1 = ConvBN(c_in, 64, (1, 1), cfg=cfg)
        self.b3x3dbl_2 = ConvBN(64, 96, (3, 3), cfg=cfg)
        self.b3x3dbl_3 = ConvBN(96, 96, (3, 3), cfg=cfg)
        self.bpool = ConvBN(c_in, pool_features, (1, 1), cfg=cfg)
        self.features = 64 + 64 + 96 + pool_features

    def forward(self, x, train):
        b1 = self.b1x1(x, train)
        b5 = self.b5x5_2(self.b5x5_1(x, train), train)
        b3 = self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x, train), train),
                            train)
        bp = self.bpool(_avg3(x), train)
        return _cat(b1, b5, b3, bp)


class InceptionB(nn.Module):
    """Grid reduction 35→17."""

    def __init__(self, c_in: int, cfg: dict):
        super().__init__()
        self.b3x3 = ConvBN(c_in, 384, (3, 3), (2, 2), "VALID", cfg=cfg)
        self.b3x3dbl_1 = ConvBN(c_in, 64, (1, 1), cfg=cfg)
        self.b3x3dbl_2 = ConvBN(64, 96, (3, 3), cfg=cfg)
        self.b3x3dbl_3 = ConvBN(96, 96, (3, 3), (2, 2), "VALID", cfg=cfg)
        self.features = 384 + 96 + c_in

    def forward(self, x, train):
        b3 = self.b3x3(x, train)
        bd = self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x, train), train),
                            train)
        bp = max_pool(x, 3, 2, "VALID")
        return _cat(b3, bd, bp)


class InceptionC(nn.Module):
    """Factorized 7×7 branches."""

    def __init__(self, c_in: int, c7: int, cfg: dict):
        super().__init__()
        self.b1x1 = ConvBN(c_in, 192, (1, 1), cfg=cfg)
        self.b7x7_1 = ConvBN(c_in, c7, (1, 1), cfg=cfg)
        self.b7x7_2 = ConvBN(c7, c7, (1, 7), cfg=cfg)
        self.b7x7_3 = ConvBN(c7, 192, (7, 1), cfg=cfg)
        self.b7x7dbl_1 = ConvBN(c_in, c7, (1, 1), cfg=cfg)
        self.b7x7dbl_2 = ConvBN(c7, c7, (7, 1), cfg=cfg)
        self.b7x7dbl_3 = ConvBN(c7, c7, (1, 7), cfg=cfg)
        self.b7x7dbl_4 = ConvBN(c7, c7, (7, 1), cfg=cfg)
        self.b7x7dbl_5 = ConvBN(c7, 192, (1, 7), cfg=cfg)
        self.bpool = ConvBN(c_in, 192, (1, 1), cfg=cfg)
        self.features = 4 * 192

    def forward(self, x, train):
        b1 = self.b1x1(x, train)
        b7 = x
        for name in ("b7x7_1", "b7x7_2", "b7x7_3"):
            b7 = getattr(self, name)(b7, train)
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"b7x7dbl_{i}")(bd, train)
        bp = self.bpool(_avg3(x), train)
        return _cat(b1, b7, bd, bp)


class InceptionD(nn.Module):
    """Grid reduction 17→8."""

    def __init__(self, c_in: int, cfg: dict):
        super().__init__()
        self.b3x3_1 = ConvBN(c_in, 192, (1, 1), cfg=cfg)
        self.b3x3_2 = ConvBN(192, 320, (3, 3), (2, 2), "VALID", cfg=cfg)
        self.b7x7x3_1 = ConvBN(c_in, 192, (1, 1), cfg=cfg)
        self.b7x7x3_2 = ConvBN(192, 192, (1, 7), cfg=cfg)
        self.b7x7x3_3 = ConvBN(192, 192, (7, 1), cfg=cfg)
        self.b7x7x3_4 = ConvBN(192, 192, (3, 3), (2, 2), "VALID", cfg=cfg)
        self.features = 320 + 192 + c_in

    def forward(self, x, train):
        b3 = self.b3x3_2(self.b3x3_1(x, train), train)
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"b7x7x3_{i}")(b7, train)
        bp = max_pool(x, 3, 2, "VALID")
        return _cat(b3, b7, bp)


class InceptionE(nn.Module):
    """Expanded-filter-bank output blocks."""

    def __init__(self, c_in: int, cfg: dict):
        super().__init__()
        self.b1x1 = ConvBN(c_in, 320, (1, 1), cfg=cfg)
        self.b3x3_1 = ConvBN(c_in, 384, (1, 1), cfg=cfg)
        self.b3x3_2a = ConvBN(384, 384, (1, 3), cfg=cfg)
        self.b3x3_2b = ConvBN(384, 384, (3, 1), cfg=cfg)
        self.b3x3dbl_1 = ConvBN(c_in, 448, (1, 1), cfg=cfg)
        self.b3x3dbl_2 = ConvBN(448, 384, (3, 3), cfg=cfg)
        self.b3x3dbl_3a = ConvBN(384, 384, (1, 3), cfg=cfg)
        self.b3x3dbl_3b = ConvBN(384, 384, (3, 1), cfg=cfg)
        self.bpool = ConvBN(c_in, 192, (1, 1), cfg=cfg)
        self.features = 320 + 768 + 768 + 192

    def forward(self, x, train):
        b1 = self.b1x1(x, train)
        b3 = self.b3x3_1(x, train)
        b3 = _cat(self.b3x3_2a(b3, train), self.b3x3_2b(b3, train))
        bd = self.b3x3dbl_2(self.b3x3dbl_1(x, train), train)
        bd = _cat(self.b3x3dbl_3a(bd, train), self.b3x3dbl_3b(bd, train))
        bp = self.bpool(_avg3(x), train)
        return _cat(b1, b3, bd, bp)


class InceptionV3(nn.Module):
    """Inception-v3: ``forward(x, train)`` on an NHWC image batch → fp32
    logits ``[B, num_classes]``. ``bn_stat_rows``: training BN
    statistics over the first N images (0 = all); ``norm_fn`` replaces
    every BN layer's training forward (the plain version, to compare
    against the kernel). Built on the meta device unless ``device`` is
    given."""

    def __init__(self, num_classes: int = 1000, dtype="bfloat16",
                 bn_stat_rows: int = 0,
                 norm_fn: Optional[TrainForward] = None, device="meta"):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = torch_dtype(dtype)
        cfg = {"dtype": self.dtype, "bn_stat_rows": bn_stat_rows,
               "norm_fn": norm_fn or fused_bn_train_forward,
               "device": device}
        self.stem1 = ConvBN(3, 32, (3, 3), (2, 2), "VALID", cfg=cfg)
        self.stem2 = ConvBN(32, 32, (3, 3), padding="VALID", cfg=cfg)
        self.stem3 = ConvBN(32, 64, (3, 3), cfg=cfg)
        self.stem4 = ConvBN(64, 80, (1, 1), padding="VALID", cfg=cfg)
        self.stem5 = ConvBN(80, 192, (3, 3), padding="VALID", cfg=cfg)
        self.block_names = []
        c = 192
        blocks = [(f"mixed5{'bcd'[i]}",
                   lambda c, pf=pf: InceptionA(c, pf, cfg))
                  for i, pf in enumerate((32, 64, 64))]
        blocks.append(("mixed6a", lambda c: InceptionB(c, cfg)))
        blocks += [(f"mixed6{'bcde'[i]}",
                    lambda c, c7=c7: InceptionC(c, c7, cfg))
                   for i, c7 in enumerate((128, 160, 160, 192))]
        blocks.append(("mixed7a", lambda c: InceptionD(c, cfg)))
        blocks += [("mixed7b", lambda c: InceptionE(c, cfg)),
                   ("mixed7c", lambda c: InceptionE(c, cfg))]
        for name, make in blocks:
            block = make(c)
            self.add_module(name, block)
            self.block_names.append(name)
            c = block.features
        self.head = Dense(c, num_classes, torch.float32, device=device)

    def logical_axes(self, key: str) -> None:
        """The reference's Inception-v3 names no logical axes: every param is
        replicated by the rule table (fsdp shards it by shape)."""
        return None

    def partitioned(self, key: str) -> bool:
        """The reference's Inception-v3 annotates no param with a partitioning:
        its exports store every leaf unboxed."""
        return False

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = nhwc_input(x, self.dtype)
        x = self.stem3(self.stem2(self.stem1(x, train), train), train)
        x = max_pool(x, 3, 2, "VALID")
        x = self.stem5(self.stem4(x, train), train)
        x = max_pool(x, 3, 2, "VALID")
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        return self.head(spatial_mean(x).float())


def inception_v3(num_classes: int = 1000, dtype="bfloat16",
                 bn_stat_rows: int = 0, **kw) -> InceptionV3:
    return InceptionV3(num_classes=num_classes, dtype=dtype,
                       bn_stat_rows=bn_stat_rows, **kw)


register_model(ModelEntry("inception-v3", "vision", inception_v3,
                          ((299, 299, 3), "bfloat16"), 1000))
