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

"""The logical-axis rule table: logical param axes → mesh axes.

The port of ``kubeflow_tpu/parallel/tensor_parallel.py``'s table. Models
name each param's axes logically (the reference's
``nn.with_partitioning``; in the port each model class's
``logical_axes(key)`` gives the same tuple for a Flax key) and a rule
table maps the names to mesh axes. The whole table is ported, ``tensor``
included: the sharded export's writer (``serving/sharding.py``) plans
with it. The trainers shard by it over ``fsdp`` only; a live model axis
raises there (ROADMAP A18).

Logical vocabulary (the reference's):

- ``batch`` → (dcn_data, data, fsdp); ``seq`` → seq; ``embed`` → fsdp;
- ``mlp``, ``heads``, ``vocab`` → tensor; ``kv`` → None;
- ``expert`` → expert; ``stage`` → pipeline.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

from kubeflow_tpu_torch.parallel.mesh import Mesh, MeshAxes, Sharding

DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("dcn_data", "data", "fsdp"),
    "seq": "seq",
    "embed": "fsdp",
    "mlp": "tensor",
    "heads": "tensor",
    "kv": None,
    "vocab": "tensor",
    "expert": "expert",
    "stage": "pipeline",
}


def rules_for(mesh: Mesh,
              overrides: Optional[Mapping[str, MeshAxes]] = None
              ) -> Dict[str, MeshAxes]:
    """DEFAULT_RULES pruned to the axes the mesh has above size 1, with
    optional per-model overrides."""
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    shape = mesh.shape

    def live(axes: MeshAxes) -> MeshAxes:
        if axes is None:
            return None
        if isinstance(axes, str):
            return axes if shape.get(axes, 1) > 1 else None
        kept = tuple(a for a in axes if shape.get(a, 1) > 1)
        return kept or None

    return {k: live(v) for k, v in rules.items()}


def logical_to_sharding(mesh: Mesh, logical_axes: Mapping[str, Any],
                        rules: Optional[Mapping[str, MeshAxes]] = None
                        ) -> Dict[str, Sharding]:
    """Flat ``{key: logical-axis tuple or None}`` → shardings. A mesh
    axis may appear once a spec: where two logical names map to the same
    axis, the first claims it and the rest are whole."""
    rules = dict(rules if rules is not None else rules_for(mesh))

    def convert(names) -> Sharding:
        if names is None:
            return Sharding(mesh, ())
        used: set = set()
        dims = []
        for n in tuple(names):
            axes = rules.get(n) if n else None
            members = (axes,) if isinstance(axes, str) else tuple(axes or ())
            kept = tuple(a for a in members if a not in used)
            used.update(kept)
            if not kept:
                dims.append(None)
            else:
                dims.append(kept[0] if len(kept) == 1 else kept)
        return Sharding(mesh, tuple(dims))

    return {k: convert(v) for k, v in logical_axes.items()}


def variables_sharding(mesh: Mesh, model: Any, keys,
                       rules: Optional[Mapping[str, MeshAxes]] = None
                       ) -> Dict[str, Sharding]:
    """Shardings of a model's Flax-keyed leaves (``keys``) from its
    ``logical_axes``; an unannotated leaf is replicated."""
    return logical_to_sharding(
        mesh, {k: model.logical_axes(k) for k in keys}, rules)
