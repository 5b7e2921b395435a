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

"""Synthetic input for the benchmark tier.

Port of ``synthetic_images`` in ``kubeflow_tpu/training/data.py``, for
one process (the per-host row split comes with the distributed
bootstrap). The generator is numpy's ``RandomState`` with the
reference's seed schedule, so the batches are the reference's to the
bit: the fp32 draws are identical, and both round them to bf16 to
nearest even.
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np
import torch

from kubeflow_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
    torch_dtype,
)

Batch = Dict[str, torch.Tensor]


def synthetic_images(
    global_batch: int,
    image_shape: Sequence[int] = (224, 224, 3),
    num_classes: int = 1000,
    seed: int = 0,
    dtype: str = "bfloat16",
    device: DeviceLike = None,
) -> Iterator[Batch]:
    """Seeded synthetic image classification batches: NHWC ``inputs``
    in ``dtype`` and int32 ``labels``, a fresh draw each step."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    step = 0
    while True:
        rng = np.random.RandomState((seed * 1_000_003 + step) % (2 ** 31))
        images = rng.standard_normal(
            (global_batch, *image_shape)).astype(np.float32)
        labels = rng.randint(0, num_classes, (global_batch,))
        yield {
            "inputs": torch.from_numpy(images).to(device=device,
                                                  dtype=dtype),
            "labels": torch.from_numpy(labels.astype(np.int32)).to(device),
        }
        step += 1
