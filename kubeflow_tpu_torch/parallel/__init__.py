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

"""The gang's mesh and its shardings: the batch axes (dcn_data, data,
fsdp), the tensor axis for the Llama and BERT and the expert axis for
an MoE Llama (``collectives.py``'s Megatron pair, ``tensor_parallel.py``'s
pieces), the seq axis (``ring_attention.py``) and the pipeline axis
(``pipeline.py``)."""

from kubeflow_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    MeshSpec,
    Sharding,
    batch_sharding,
    build_mesh,
    fsdp_params_sharding,
    logical_sharding,
    replicated,
)
