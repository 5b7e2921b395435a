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

"""The pod env's say in where the port runs.

The port of ``kubeflow_tpu/utils/platform.py``. The operator runs a job
in its simulated mode by putting ``JAX_PLATFORMS=cpu`` in the pod's env
(the reference's workers read it as "run on the CPU"). The port reads
the same variable: ``cpu`` means the CPU, any other value or none
means the card. It is the caller asking for the CPU, not a fallback: a
pod without that env on a machine without CUDA still raises where the
device resolves (``utils/device.py``).

The entry points the reference points at ``sync_platform_from_env``
(the pod launcher, the trainer CLIs, the model server, ``kft-export``)
take their default device from :func:`device_from_env`; an explicit
``--device`` still wins.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

#: The env var the operator's simulated mode sets.
ENV_PLATFORMS = "JAX_PLATFORMS"


def device_from_env(env: Mapping[str, str] = os.environ) -> str:
    """``"cpu"`` where the env's ``JAX_PLATFORMS`` is ``cpu``, else
    ``"cuda"``."""
    platforms = (env.get(ENV_PLATFORMS) or "").strip().lower()
    return "cpu" if platforms == "cpu" else "cuda"


def default_device(device: Optional[str],
                   env: Mapping[str, str] = os.environ) -> str:
    """A CLI's ``--device``: the flag where given, else the env's."""
    return device if device else device_from_env(env)
