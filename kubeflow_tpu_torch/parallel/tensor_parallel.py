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

"""The logical-axis rule table: logical param axes → mesh axes, and
each tensor rank's piece of a leaf.

The port of ``kubeflow_tpu/parallel/tensor_parallel.py``'s table. Models
name each param's axes logically (the reference's
``nn.with_partitioning``; in the port each model class's
``logical_axes(key)`` gives the same tuple for a Flax key) and a rule
table maps the names to mesh axes. The whole table is ported: the
sharded export's writer (``serving/sharding.py``) plans with it, and
the trainers and the models built on a mesh (the Llama, its MoE and
BERT) split by it over ``fsdp``, ``expert`` and ``tensor``. Where the
reference lets GSPMD derive the collectives, the port's models issue
them themselves (``parallel/collectives.py``).

One split is the port's own. The table maps ``kv`` to None, so the
reference keeps k_proj and v_proj whole; a tensor rank needs only the kv
heads its query heads read (GQA group ``i // (H / Hkv)``), so where
``Hkv % tensor == 0`` a model's :meth:`split_axes` names that dim
``kv_heads``, which :data:`KV_HEADS_RULE` maps to ``tensor``: each rank
holds its kv-head group's columns, a column slice of the whole kernel,
and gathers give the reference's whole layout back. Otherwise every rank
holds the whole kernel and indexes its group (:func:`kv_group`).

Logical vocabulary (the reference's):

- ``batch`` → (dcn_data, data, fsdp); ``seq`` → seq; ``embed`` → fsdp;
- ``mlp``, ``heads``, ``vocab`` → tensor; ``kv`` → None;
- ``expert`` → expert; ``stage`` → pipeline.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

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

#: The port's own entry beside the reference's table: a kv-head dim
#: splits over tensor where the model splits its kv heads.
KV_HEADS_RULE: Dict[str, MeshAxes] = {"kv_heads": "tensor"}


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
    :func:`split_axes`; an unannotated leaf is replicated."""
    rules = dict(rules if rules is not None else rules_for(mesh))
    for name, axis in KV_HEADS_RULE.items():
        rules.setdefault(name, axis if mesh.shape[axis] > 1 else None)
    return logical_to_sharding(
        mesh, {k: split_axes(model, k) for k in keys}, rules)


def split_axes(model: Any, key: str) -> Optional[Tuple]:
    """The logical axes by which the port splits a model's Flax leaf
    ``key``: the model's ``split_axes`` where it has one (the Llama's
    kv-head split), else its ``logical_axes``."""
    fn = getattr(model, "split_axes", None) or model.logical_axes
    return fn(key)


def kv_heads_split(num_kv_heads: int, tensor: int) -> bool:
    """Whether each tensor rank holds only its kv-head group."""
    return num_kv_heads % tensor == 0


def kv_group(num_heads: int, num_kv_heads: int, tensor: int,
             rank: int) -> Sequence[int]:
    """The kv head each of tensor rank ``rank``'s query heads reads, as
    an index into the kv heads the rank holds: its own group where
    :func:`kv_heads_split` (the index then runs from 0), every kv head
    otherwise."""
    local = num_heads // tensor
    ratio = num_heads // num_kv_heads
    heads = [rank * local + i for i in range(local)]
    if kv_heads_split(num_kv_heads, tensor):
        first = rank * (num_kv_heads // tensor)
        return [h // ratio - first for h in heads]
    return [h // ratio for h in heads]


def tensor_piece(model: Any, key: str, shape: Sequence[int], mesh: Mesh,
                 axes: Sequence[str] = ("tensor",)) -> Tuple[slice, ...]:
    """This rank's piece of a model's Flax leaf ``key`` of Flax
    ``shape`` over ``axes`` of ``mesh`` (default: the tensor axis alone),
    by the rule table; a leaf the table keeps whole takes every index.
    A leaf split over several axes is cut on each of its dims: an MoE's
    ``w_in [E, D, F]`` (``("expert", "embed", "mlp")``) over ``expert``
    on dim 0, ``fsdp`` on dim 1 and ``tensor`` on dim 2. A dim that does
    not split evenly raises, as the reference's sharded init does."""
    sh = variables_sharding(mesh, model, [key])[key]
    return sh.only(axes).index(tuple(shape))
