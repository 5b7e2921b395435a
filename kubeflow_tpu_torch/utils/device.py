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

"""Where the port's entry points run.

The port runs on the GPU. ``resolve_device(None)`` is ``cuda``; the CPU
is used only when the caller asks for it (the tests do), and a machine
without CUDA raises instead of carrying on on the CPU, so a measurement
can never silently describe the wrong device.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"`` → the CPU; any CUDA device is
    checked to exist. Raises ``RuntimeError`` when CUDA is wanted and
    absent.

    Also turns TF32 off for matrix products and cuDNN. The reference's
    ``lm_head`` is a full-fp32 product over an fp32-cast input
    (``kubeflow_tpu/models/llama.py``: ``_dense(..., jnp.float32,
    "lm_head")``), and the fp32 parity tests hold logits at 1e-4; TF32
    keeps about three decimal digits and would break both.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on the GPU. Pass "
            "device='cpu' to run on the CPU explicitly.")
    return dev


def torch_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """A model's ``dtype`` kwarg as exported (``"float32"``,
    ``"bfloat16"``) or as a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported model dtype {dtype!r}") from None
