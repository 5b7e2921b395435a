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

"""kubeflow_tpu_torch — ``kubeflow_tpu`` in PyTorch, on an NVIDIA H100.

The layout mirrors the JAX package module for module
(``kubeflow_tpu/models/llama.py`` ↔ ``kubeflow_tpu_torch/models/llama.py``),
so each counterpart is easy to find. The package imports ``torch`` and
never ``jax``, ``flax`` or ``kubeflow_tpu``: what it needs from the JAX
package it keeps as its own copy.

- ``models``: the model registry, the dense Llama family and ResNet.
- ``ops``: attention and ghost batch norm in plain PyTorch, and
  ``flash_attention`` and ``fused_bn_train_forward``, whose CUDA paths
  are the hand-written Hopper kernels in ``csrc/``.
- ``inference``: greedy and sampled KV-cache generation and the
  continuous-batching decode engine.
- ``serving``: the model server: signatures and exports,
  ``LoadedModel``, ``ModelManager``, the REST, SSE and gRPC servers and
  their wire.
- ``obs``, ``scaling``: metrics, tracing and the scrape handlers; the
  admission arithmetic and replica roles the server uses.
- ``training``: the vision train step, the ``tpu-cnn`` benchmark,
  evaluation and synthetic data.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
