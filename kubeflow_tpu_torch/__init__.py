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

"""kubeflow_tpu_torch — the serving engine of ``kubeflow_tpu`` in PyTorch,
on an NVIDIA H100.

The layout mirrors the JAX package module for module
(``kubeflow_tpu/models/llama.py`` ↔ ``kubeflow_tpu_torch/models/llama.py``),
so each counterpart is easy to find. The package imports ``torch`` and
never ``jax``, ``flax`` or ``kubeflow_tpu``: what it needs from the JAX
package it keeps as its own copy.

- ``models``: the model registry and the dense Llama family.
- ``ops``: attention in plain PyTorch, and ``flash_attention``, whose
  CUDA path is the hand-written Hopper kernel in ``csrc/``.
- ``inference``: greedy KV-cache generation.
- ``serving``: model signatures and ``LoadedModel``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
