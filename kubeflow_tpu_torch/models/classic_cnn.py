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

"""Classic CNNs: VGG-16 and AlexNet, in PyTorch.

Port of ``kubeflow_tpu/models/classic_cnn.py``, the rest of the
``tpu-cnn`` ``--model`` flag's values. Convs with biases and relu, Flax
``SAME`` convs and ``VALID`` max pools (models/layers.py), two
4096-wide fully connected layers over the NHWC-ordered flattening (the
order of the reference's ``x.reshape((B, -1))``), and an fp32 head. No
BN and no dropout: train and eval are one function, and the models have
no ``batch_stats``. Both train at the registry's ``bench_lr`` of 0.01:
without normalisation they diverge at the BN-era 0.1.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from kubeflow_tpu_torch.models.layers import Conv, Dense, max_pool, nhwc_input
from kubeflow_tpu_torch.models.registry import ModelEntry, register_model
from kubeflow_tpu_torch.utils.device import torch_dtype


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """``x.reshape((B, -1))`` of the NHWC batch x is a view of."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class VGG(nn.Module):
    """Stacked 3×3 conv stages + two FC layers; ``stage_sizes`` (2, 2,
    3, 3, 3) is VGG-16. ``image_size`` sizes fc1's input (the flattened
    final map). Built on the meta device unless ``device`` is given."""

    #: ``image_size`` sizes a param (the trainer passes it on).
    SIZED_BY_IMAGE = True

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 3, 3, 3),
                 widths: Sequence[int] = (64, 128, 256, 512, 512),
                 num_classes: int = 1000, dense_width: int = 4096,
                 dtype="bfloat16", image_size: int = 224, device="meta"):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.conv_names = []
        c, size = 3, image_size
        for stage, (depth, width) in enumerate(zip(stage_sizes, widths)):
            names = []
            for i in range(depth):
                name = f"conv{stage}_{i}"
                self.add_module(name, Conv(c, width, (3, 3), bias=True,
                                           device=device))
                names.append(name)
                c = width
            self.conv_names.append(names)
            size //= 2
        self.fc1 = Dense(size * size * c, dense_width, self.dtype,
                         device=device)
        self.fc2 = Dense(dense_width, dense_width, self.dtype, device=device)
        self.head = Dense(dense_width, num_classes, torch.float32,
                          device=device)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        del train  # no BN or dropout: train == eval
        x = nhwc_input(x, self.dtype)
        for names in self.conv_names:
            for name in names:
                x = F.relu(getattr(self, name)(x))
            x = max_pool(x, 2, 2)
        x = F.relu(self.fc1(_flatten_nhwc(x)))
        x = F.relu(self.fc2(x))
        return self.head(x.float())


class AlexNet(nn.Module):
    """Five convs + three FC layers (single tower, no LRN). ``image_size``
    sizes fc1's input. Built on the meta device unless ``device`` is
    given."""

    #: ``image_size`` sizes a param (the trainer passes it on).
    SIZED_BY_IMAGE = True

    def __init__(self, num_classes: int = 1000, dense_width: int = 4096,
                 dtype="bfloat16", image_size: int = 224, device="meta"):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.conv1 = Conv(3, 96, (11, 11), (4, 4), bias=True, device=device)
        self.conv2 = Conv(96, 256, (5, 5), bias=True, device=device)
        self.conv3 = Conv(256, 384, (3, 3), bias=True, device=device)
        self.conv4 = Conv(384, 384, (3, 3), bias=True, device=device)
        self.conv5 = Conv(384, 256, (3, 3), bias=True, device=device)
        size = -(-image_size // 4)
        for _ in range(3):
            size = (size - 3) // 2 + 1
        self.fc1 = Dense(size * size * 256, dense_width, self.dtype,
                         device=device)
        self.fc2 = Dense(dense_width, dense_width, self.dtype, device=device)
        self.head = Dense(dense_width, num_classes, torch.float32,
                          device=device)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        del train
        x = nhwc_input(x, self.dtype)
        x = max_pool(F.relu(self.conv1(x)), 3, 2)
        x = max_pool(F.relu(self.conv2(x)), 3, 2)
        x = F.relu(self.conv3(x))
        x = F.relu(self.conv4(x))
        x = max_pool(F.relu(self.conv5(x)), 3, 2)
        x = F.relu(self.fc1(_flatten_nhwc(x)))
        x = F.relu(self.fc2(x))
        return self.head(x.float())


def vgg16(num_classes: int = 1000, dtype="bfloat16", **kw) -> VGG:
    return VGG(num_classes=num_classes, dtype=dtype, **kw)


def vgg_test(num_classes: int = 10, dtype="bfloat16", **kw) -> VGG:
    """3-stage narrow VGG for 32² CI inputs."""
    kw.setdefault("image_size", 32)
    return VGG(stage_sizes=(1, 1, 1), widths=(8, 16, 32),
               num_classes=num_classes, dense_width=64, dtype=dtype, **kw)


def alexnet(num_classes: int = 1000, dtype="bfloat16", **kw) -> AlexNet:
    return AlexNet(num_classes=num_classes, dtype=dtype, **kw)


register_model(ModelEntry("vgg16", "vision", vgg16,
                          ((224, 224, 3), "bfloat16"), 1000, bench_lr=0.01))
register_model(ModelEntry("vgg-test", "vision", vgg_test,
                          ((32, 32, 3), "bfloat16"), 10, bench_lr=0.01))
register_model(ModelEntry("alexnet", "vision", alexnet,
                          ((224, 224, 3), "bfloat16"), 1000, bench_lr=0.01))
